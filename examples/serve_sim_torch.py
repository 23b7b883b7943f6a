"""Request-level serving simulation of the PyTorch port: the lap of
``examples/serve_sim.py`` on ``repro_torch.sim``.

A short open-loop Poisson run of a 70B-class model on the reference's
v5e serving slice (the port's copy of ``v5e_serving``, built bit for
bit): requests arrive as events, prefill/decode ops are injected into
the live DES run, KV slots contend, and TTFT/TPOT/latency percentiles
come out of the stats tree.  It prints the original's lines, so the two
compare line for line; nothing here imports JAX or the ``repro``
package, and nothing runs on a device (the simulator is pure Python).

  PYTHONPATH=src python examples/serve_sim_torch.py
"""

from repro_torch.sim import (ExitEventType, ServeSim, ServingCost, Simulator,
                             poisson_requests, v5e_serving)


def main() -> None:
    board = v5e_serving(8, 8)
    cost = ServingCost.from_params(70e9, layers=80, d_model=8192,
                                   chips=board.machine.num_chips)
    requests = poisson_requests(60, 40.0, seed=17,
                                prompt_len=(64, 512), decode_len=(16, 64))
    srv = ServeSim(cost=cost, requests=requests, slots=16,
                   seq_capacity=1024, slo_ttft_s=0.05, slo_latency_s=2.0)
    sim = Simulator(board, srv)

    events = list(sim.run())
    assert events[-1].kind is ExitEventType.DONE
    res = sim.result()
    s = srv.summary()

    print(f"board              : {board.name}")
    print(f"requests served    : {int(s['requests'])} "
          f"({int(s['tokens_out'])} tokens, "
          f"{int(srv.s_decode_steps.value())} decode steps)")
    print(f"simulated span     : {s['span_s'] * 1e3:.1f} ms "
          f"({res.events} engine events)")
    print(f"throughput/goodput : {s['throughput_rps']:.1f} / "
          f"{s['goodput_rps']:.1f} rps "
          f"({int(s['slo_violations'])} SLO violations)")
    print(f"TTFT p50/p99       : {s['p50_ttft_s'] * 1e3:.2f} / "
          f"{s['p99_ttft_s'] * 1e3:.2f} ms")
    print(f"latency p50/p99    : {s['p50_latency_s'] * 1e3:.1f} / "
          f"{s['p99_latency_s'] * 1e3:.1f} ms")
    print(f"mean TPOT          : {s['mean_tpot_s'] * 1e3:.3f} ms/token")
    print(f"mean decode batch  : {s['mean_batch']:.1f} of {srv.slots} slots")

    assert s["requests"] == 60, "all requests must complete"
    assert s["goodput_rps"] > 0, "goodput must be nonzero"
    flat = srv.stats.flat()
    assert flat["serve.requests_done"] == 60
    assert flat["serve.ttft"]["count"] == 60
    print("serving smoke OK")


if __name__ == "__main__":
    main()
