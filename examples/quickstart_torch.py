"""Quickstart of the PyTorch port: the g5x workflow of
``examples/quickstart.py`` on ``repro_torch``, in one page.

1. pick an architecture config     (gem5: choose known-good config)
2. build the model + train step    (gem5: compose SimObjects in Python)
3. train a few steps for real      (gem5: KVM/native fidelity)
4. dry-run the step on fake
   tensors and cost its ops        (gem5: atomic fidelity)
5. replay the step's cost on a
   parameterized model of the card (gem5: detailed/O3 fidelity)
6. script the simulation with the
   Simulator exit-event loop       (gem5 stdlib: boards + exit events,
                                    checkpoint / restore / re-sweep)

Run on the card: PYTHONPATH=src python examples/quickstart_torch.py
On the CPU, add:  --device cpu

Everything here is the port's (``repro_torch``): the model, the train
step, the fidelity backends, and the simulator that times the trace in
steps 5 and 6 (``repro_torch.sim`` on ``h100_card()``, one NVIDIA H100
SXM5).  Nothing here imports JAX or the ``repro`` package.
``--trace-dir`` and ``--debug-flags`` work as in
``examples/quickstart.py``.
"""

import argparse

from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.desim.machine import H100_SXM
from repro_torch.core.desim.trace import analytic_trace
from repro_torch.core.fidelity import (DesimBackend, DryRunBackend,
                                       StepProgram, specs_of)
from repro_torch.data import SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.sim import (ExitEventType, Simulator, SteadyStateWorkload,
                             h100_card)
from repro_torch.train import (TrainOptions, batch_to, build_train_step,
                               init_train_state)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="write an m5out-style dir (stats.txt, config.json, "
                         "telemetry.json, Perfetto trace.json) for step 6")
    ap.add_argument("--debug-flags", default=None, metavar="FLAGS",
                    help="comma-separated DPRINTF flags (e.g. Exec,Dcn or "
                         "All)")
    cli = ap.parse_args(argv)
    if cli.debug_flags:
        from repro_torch.sim import enable_debug_flags
        enable_debug_flags(cli.debug_flags)
    device = resolve_device(cli.device)

    # -- 1. config ----------------------------------------------------------
    cfg = smoke(get_config("olmoe-1b-7b"))       # reduced MoE config
    shape = ShapeConfig("quick", seq_len=32, global_batch=4, kind="train")
    print(f"arch={cfg.name} layers={cfg.n_layers} experts={cfg.n_experts} "
          f"device={device}")

    # -- 2. model + step -----------------------------------------------------
    model = build_model(cfg)
    opts = TrainOptions(peak_lr=5e-3, warmup=5, total_steps=30, chunk=16)
    state = init_train_state(model, 0, opts, device)
    train_step = build_train_step(model, opts)

    # -- 3. native fidelity: actually train ----------------------------------
    pipe = SyntheticPipeline(cfg, shape)
    for step_i in range(30):
        state, metrics = train_step(state, batch_to(pipe.batch(step_i),
                                                    device))
        if step_i % 10 == 0:
            print(f"step {step_i:3d} loss={float(metrics['loss']):.3f} "
                  f"aux={float(metrics['aux_loss']):.3f}")
    print(f"final loss={float(metrics['loss']):.3f}")

    # -- 4. dryrun fidelity: the step's ops on fake tensors ------------------
    prog = StepProgram("quick_train", build_train_step(model, opts),
                       (specs_of(state),
                        specs_of(batch_to(pipe.batch(0), "cpu"))),
                       device=device)
    rep = DryRunBackend().run(prog)
    print(f"dryrun: flops/step={rep.flops:.2e} hbm_bytes="
          f"{rep.bytes_accessed:.2e} ({len(rep.detail['ops'])} ops, "
          f"kernels {rep.detail['kernels']})")

    # -- 5. desim fidelity: predicted step time on the card's model ---------
    rep2 = DesimBackend(board=h100_card()).run(prog, dryrun_report=rep)
    print(f"desim: predicted step time on one H100 = "
          f"{rep2.predicted_step_s:.3e} s")

    # -- 6. the Simulator front-end: exit events + checkpoint/restore --------
    # a 16-step steady-state training workload with the dry run's per-step
    # costs spread over the layers (per-layer all-reduce: data-parallel
    # grad sync over the board's cards; free on one card)
    L = cfg.n_layers
    card = h100_card()
    step_trace = analytic_trace(
        "quick_step", L, rep.flops / L, rep.bytes_accessed / L,
        [{"kind": "all-reduce", "bytes": 2 * rep.bytes_accessed / L,
          "participants": card.machine.num_chips}])
    sim = Simulator(card, SteadyStateWorkload(step_trace, 16),
                    outdir=cli.trace_dir,
                    trace_events=cli.trace_dir is not None,
                    verbose=cli.trace_dir is not None)
    per_step = h100_card().executor().execute(step_trace).makespan_s
    mid = int(per_step * 1e9 * 4)                # ticks are ns: 4 steps in
    sim.schedule_max_tick(mid)                   # pause after ~4 steps...
    sim.schedule_checkpoint(mid)                 # ...checkpoint there
    ckpt = None
    for ev in sim.run():
        print(f"  exit event: {ev}")
        if ev.kind is ExitEventType.CHECKPOINT:
            ckpt = ev.payload["checkpoint"]
    # restore the checkpoint onto a machine with doubled HBM bandwidth: the
    # remaining 12 steps re-time under the new hardware (checkpoint once,
    # sweep hardware -- the gem5 DSE workflow)
    fast = Simulator.from_checkpoint(ckpt, board=h100_card(
        chip={"hbm_bw": 2 * H100_SXM["hbm_bw"]}))
    res_fast = fast.run_to_completion()
    print(f"simulator: 16-step nominal={sim.result().makespan_s:.3e}s "
          f"2xHBM-from-checkpoint={res_fast.makespan_s:.3e}s")
    if cli.trace_dir:
        print(f"wrote m5out-style output dir: {cli.trace_dir}/"
              "{stats.txt,config.json,telemetry.json,trace.json}")
    print("quickstart OK")


if __name__ == "__main__":
    main()
