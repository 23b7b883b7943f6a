#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (the script then exits non-zero):

1. card     -- the card's name and power limit (nvidia-smi), torch and CUDA
2. build    -- compile the flash-attention kernel from the sources in this
               checkout (nvcc, sm_90a) and print the compiler's report
3. sweep    -- the kernel against its plain PyTorch version on the card, over
               the flash sweep of tests/test_kernels.py x {f32, bf16} plus
               ragged lengths, GQA, d=16 and a window
4. model    -- full-width stablelm-1.6b (random weights from --seed, bf16):
               a 2048-token prefill through the kernel path, and through the
               plain attention with the same weights; logits compared
5. serve    -- BatchServer(slots=4, seq_capacity=4096) at full width serves 8
               requests of 128-2048 prompt tokens, 32 new tokens each: the
               main path, with the kernel's launch count read around it
6. timing   -- kernel, plain version and scaled_dot_product_attention (a
               yardstick the port never calls) at the main path's shape,
               then the kernel alone at each prompt length the serve run had
7. profile  -- torch.profiler over a second, smaller serve run: the device's
               busy share of prefill and of decode steps, and device time by
               kernel name

It prints the kernel table as one JSON line, then the card's name and power
limit, then the result line {"ok": true, "device": {...}} last.  Without a
CUDA device, or without the repo's ``src/repro_torch`` beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "stablelm-1.6b"
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
SERVE_REQUESTS, SERVE_SLOTS, SERVE_CAP, SERVE_NEW = 8, 4, 4096, 32
PROFILE_REQUESTS, PROFILE_NEW, PROFILE_TOP = 4, 8, 8
MAIN_SHAPE = dict(b=1, s=2048, h=32, d=64)    # stablelm prefill attention
# model phase: the kernel and plain paths differ only in the order of f32
# sums inside attention, which flips bf16 roundings of attention outputs by
# one ulp (2^-8 relative); 24 residual layers spread the flips.  5% of the
# largest logit is ~13 such ulps; a wrong mask, scale or head mapping moves
# logits by the order of the logits themselves.
LOGIT_RTOL = 0.05
TOL = {"float32": 2e-5, "bfloat16": 2e-2}     # tests/test_kernels.py


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_sweep(torch, ops) -> None:
    sweep = [(2, 256, 4, 4, 64, 0), (1, 512, 2, 2, 128, 0),
             (2, 256, 4, 4, 64, 128), (1, 128, 8, 8, 32, 0),
             (3, 192, 2, 2, 64, 0),
             # ragged s, GQA 32/8 at d=128, d=16, a window, not causal
             # (window None)
             (1, 1, 4, 4, 64, 0), (1, 77, 4, 4, 64, 0), (1, 1000, 4, 4, 64, 0),
             (1, 512, 32, 8, 128, 0), (2, 50, 4, 1, 16, 0),
             (1, 300, 4, 2, 64, 100), (2, 130, 4, 2, 32, None),
             # stablelm's own heads at its longest served prompt and at the
             # model phase's length
             (1, 1762, 32, 32, 64, 0), (1, 2048, 32, 32, 64, 0)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for b, s, h, kvh, d, win in sweep:
            q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
            k = torch.randn(b, s, kvh, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(b, s, kvh, d, generator=gen, device="cuda").to(dtype)
            kw = dict(causal=win is not None, window=win or 0)
            got = ops.flash_attention(q, k, v, **kw)
            want = ops.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            lim = TOL[name] * (1 + want.float().abs())
            ok = bool((err <= lim).all()) and bool(torch.isfinite(got).all())
            case = (f"{name} b={b} s={s} h={h} kvh={kvh} d={d} "
                    f"causal={kw['causal']} window={kw['window']}")
            print(f"sweep {case}: max_abs_err={float(err.max()):.3e} "
                  f"tol={TOL[name]} {'ok' if ok else 'FAIL'}")
            check(ok, f"kernel disagrees with its plain version ({case})")


def phase_model(torch, np, cfg, model, params, layers, ops, seed: int):
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, 2048)
    tokens = torch.as_tensor(prompt, device="cuda")[None]
    t0 = time.perf_counter()
    logits_k, _ = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    # the plain path: the same model with the kernel's plain version put in
    # the kernel's place, here only
    layers.flash_attention = ops.flash_attention_plain
    try:
        logits_p, _ = model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
    finally:
        layers.flash_attention = ops.flash_attention
    lk, lp = logits_k[0, -1].float(), logits_p[0, -1].float()
    check(logits_k.shape == (1, 1, 100352), f"logits {tuple(logits_k.shape)}")
    check(bool(torch.isfinite(lk).all()), "non-finite logits")
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    top2 = torch.topk(lp, 2).values
    print(f"model {ARCH} prefill s=2048 bf16: kernel path {t_k * 1e3:.1f} ms "
          f"(first call); max|dlogit|={err:.4e} vs max|logit|={scale:.4f} "
          f"(tol {LOGIT_RTOL} x max|logit|); argmax kernel "
          f"{int(lk.argmax())} plain {int(lp.argmax())} (top-2 gap "
          f"{float(top2[0] - top2[1]):.4f})")
    check(err <= LOGIT_RTOL * scale, "kernel path logits disagree")
    check(int(lk.argmax()) == int(lp.argmax()), "argmax differs")


def phase_serve(torch, np, cfg, model, params, ops, seed: int, card: str):
    from repro_torch.serve import BatchServer, Request
    rng = np.random.default_rng(seed)
    lens = rng.integers(128, 2049, SERVE_REQUESTS)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(n)),
                    max_new_tokens=SERVE_NEW) for i, n in enumerate(lens)]
    srv = BatchServer(model, params, slots=SERVE_SLOTS,
                      seq_capacity=SERVE_CAP, device="cuda")
    ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    done = srv.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.flash_attention.launches
    check(len(done) == SERVE_REQUESTS, f"{len(done)} requests finished")
    for r in done:
        check(len(r.output) == SERVE_NEW, f"rid {r.rid}: {len(r.output)} "
                                          f"tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output),
              f"rid {r.rid}: token out of vocab")
    want = cfg.n_layers * SERVE_REQUESTS
    check(launches == want, f"flash_attention launched {launches} times "
                            f"in the serve run, want {want}")
    # the server's first token is a batch-1 prefill: reproduce one
    r0 = min(done, key=lambda r: r.rid)
    lg, _ = model.prefill(srv.params, {
        "tokens": torch.as_tensor(r0.prompt, device="cuda")[None]},
        seq_capacity=SERVE_CAP)
    check(int(lg[0, -1].float().argmax()) == r0.output[0],
          "first token differs from a standalone prefill")
    pre = np.array(srv.prefill_seconds) * 1e3
    dec = np.array(srv.decode_seconds) * 1e3
    tokens = sum(len(r.output) for r in done)
    print(f"serve {ARCH} slots={SERVE_SLOTS} cap={SERVE_CAP} prompts "
          f"{sorted(int(n) for n in lens)}: {tokens} tokens in {wall:.3f} s "
          f"= {tokens / wall:.1f} tokens/s; prefill {pre.mean():.2f} ms/request "
          f"(min {pre.min():.2f}, max {pre.max():.2f}); decode "
          f"{dec.mean():.2f} ms/step over {srv.decode_steps} steps "
          f"(median {np.median(dec):.2f}); flash launches {launches} "
          f"[{card}]")
    return launches, [int(n) for n in lens]


def phase_timing(torch, ops):
    import torch.nn.functional as F
    b, s, h, d = (MAIN_SHAPE[k] for k in "bshd")
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention_plain(q, k, v).float()
    diff = (got.float() - want).abs()
    err = float(diff.max())
    check(bool((diff <= TOL["bfloat16"] * (1 + want.abs())).all()),
          f"main-shape kernel error {err}")
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v))
    plain_ms = cuda_ms(lambda: ops.flash_attention_plain(q, k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    flops = 2 * b * h * s * s * d               # causal: half of 4 b h s^2 d
    nbytes = 4 * b * s * h * d * q.element_size()
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms, bound_by = max((t_ops, "operations"), (t_bytes, "bytes"))
    print(f"timing b={b} s={s} h={h} d={d} bf16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); "
          f"kernel at {flops / ms / 1e9:.2f} TFLOP/s; max_abs_err {err:.3e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def phase_lengths(torch, ops, lens, n_layers: int, card: str) -> None:
    """The kernel alone at stablelm's heads and each served prompt length:
    what its launches (one per layer per request) cost in the serve run."""
    h, d = MAIN_SHAPE["h"], MAIN_SHAPE["d"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    per_req = []
    for s in sorted(lens):
        q, k, v = (torch.randn(1, s, h, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        per_req.append(cuda_ms(lambda: ops.flash_attention(q, k, v)))
        print(f"lengths s={s}: kernel {per_req[-1]:.4f} ms per launch, "
              f"{per_req[-1] * n_layers:.3f} ms per prefill")
    print(f"lengths: kernel {sum(per_req) * n_layers:.3f} ms over the "
          f"serve run's {len(per_req)} prefills ({n_layers} launches "
          f"each) [{card}]")


def _busy_us(spans, lo: float, hi: float) -> float:
    """Length of the union of ``spans`` (sorted (start, end)) inside
    [lo, hi)."""
    busy, edge = 0.0, lo
    for a, b in spans:
        a, b = max(a, edge), min(b, hi)
        if b > a:
            busy += b - a
            edge = b
    return busy


def phase_profile(torch, np, cfg, model, params, seed: int, card: str):
    """Trace a serve run of PROFILE_REQUESTS requests and split its time
    into prefill and decode windows.  A window runs from the start of its
    step's span to the start of the next span, so it holds the step's host
    work and the read-back that waits for the device."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.serve import BatchServer, Request
    rng = np.random.default_rng(seed + 1)
    lens = rng.integers(128, 2049, PROFILE_REQUESTS)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(n)),
                    max_new_tokens=PROFILE_NEW) for i, n in enumerate(lens)]
    srv = BatchServer(model, params, slots=SERVE_SLOTS,
                      seq_capacity=SERVE_CAP, device="cuda")

    def spanned(name, fn):
        def step(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return step
    srv._prefill = spanned("prefill", srv._prefill)
    srv._decode = spanned("decode", srv._decode)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("serve"):
            srv.serve(reqs)
            torch.cuda.synchronize()
    trace = ROOT / "chiprun_out" / "profile_trace.json"
    trace.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    check(len(dev) > 0, "the profiler saw no device activity")
    spans = sorted((e["ts"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"] in ("prefill", "decode"))
    serve = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "serve"]
    check(len(serve) == 1, f"{len(serve)} serve spans in the trace")
    end = serve[0]["ts"] + serve[0]["dur"]
    n_pre = sum(1 for _, n in spans if n == "prefill")
    check(n_pre == PROFILE_REQUESTS and len(spans) == n_pre + srv.decode_steps,
          f"trace holds {len(spans)} step spans, want {PROFILE_REQUESTS} "
          f"prefills and {srv.decode_steps} decode steps")
    intervals = [(a, b) for a, b, _ in dev]
    wall = {"prefill": 0.0, "decode": 0.0}
    busy = {"prefill": 0.0, "decode": 0.0}
    by_name = {"prefill": {}, "decode": {}}
    for i, (t0, kind) in enumerate(spans):
        t1 = spans[i + 1][0] if i + 1 < len(spans) else end
        wall[kind] += t1 - t0
        busy[kind] += _busy_us(intervals, t0, t1)
        for a, b, name in dev:
            if t0 <= a < t1:
                tot, n = by_name[kind].get(name, (0.0, 0))
                by_name[kind][name] = (tot + b - a, n + 1)
    for kind, steps in (("prefill", n_pre), ("decode", srv.decode_steps)):
        share = busy[kind] / wall[kind]
        print(f"profile {kind}: {steps} steps, {wall[kind] / 1e3 / steps:.3f}"
              f" ms per step on the host clock (profiled), device busy "
              f"{busy[kind] / 1e3 / steps:.3f} ms per step = {share:.4f} of "
              f"it [{card}]")
        top = sorted(by_name[kind].items(), key=lambda kv: -kv[1][0])
        for name, (tot, n) in top[:PROFILE_TOP]:
            print(f"  {kind} device {tot / 1e3 / steps:.4f} ms per step, "
                  f"{n} launches: {name[:110]}")
        flash = sum(tot for name, (tot, _) in by_name[kind].items()
                    if "flash" in name)
        print(f"  {kind} flash kernel {flash / 1e3 / steps:.4f} ms per step "
              f"= {flash / max(busy[kind], 1e-9):.4f} of device busy time")
    print(f"profile: prompts {sorted(int(n) for n in lens)}, "
          f"{PROFILE_NEW} new tokens each, {len(dev)} device events")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no repro_torch package under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.models import build_model
    from repro_torch.models import layers

    # 1. card
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = kernel.build()
    kernel.load()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # 3. kernel against its plain version
    phase_sweep(torch, ops)

    # 4. full width, kernel path against plain path
    cfg = get_config(ARCH)
    model = build_model(cfg)                       # bf16 compute
    t0 = time.perf_counter()
    params = model.load(model.init(args.seed, "cuda"), "cuda")
    torch.cuda.synchronize()
    print(f"model: {ARCH} params drawn and cast to bf16 in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B params")
    phase_model(torch, np, cfg, model, params, layers, ops, args.seed)

    # 5. serve: the main path, launches counted around it alone
    launches, lens = phase_serve(torch, np, cfg, model, params, ops,
                                 args.seed, card)

    # 6. times at the main path's shape, then at each served length
    t = phase_timing(torch, ops)
    phase_lengths(torch, ops, lens, cfg.n_layers, card)

    # 7. where a served request's time goes on the device
    phase_profile(torch, np, cfg, model, params, args.seed, card)

    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:37",
           "launches": launches, **t}
    print(json.dumps({"kernels": [row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
