"""Autoscaled fleet serving of the PyTorch port: the lap of
``examples/fleet_sim.py`` on ``repro_torch.sim`` and
``repro_torch.serve``.

A flash crowd hits a fleet of 70B-class continuous-batching replicas on
the reference's v5e fleet board (the port's copy of ``v5e_fleet``): the
least-loaded router spreads requests, the autoscaler reacts to queue/SLO
pressure by warming new replicas, and scale actions surface as
SCALE_UP/SCALE_DOWN exit events.  The same pure ``FleetPolicy`` then
replays the recorded event feed through the port's ``FleetController``
and the decision logs are asserted identical.  It prints the original's
lines, so the two compare line for line; nothing here imports JAX or the
``repro`` package, and nothing runs on a device.

  PYTHONPATH=src python examples/fleet_sim_torch.py
"""

from repro_torch.core.desim.simnodes import to_ticks
from repro_torch.serve import FleetController, FleetPolicy
from repro_torch.sim import (ExitEventType, FleetSim, ServingCost, Simulator,
                             flash_crowd_requests, v5e_fleet)


def mk_policy() -> FleetPolicy:
    return FleetPolicy("least_loaded", min_replicas=2, max_replicas=6,
                       slots_per_replica=8,
                       cold_start_ticks=to_ticks(1.0),
                       control_period_ticks=to_ticks(0.5), seed=7)


def main() -> None:
    board = v5e_fleet(max_replicas=6, nx=4, ny=4)
    cost = ServingCost.from_params(70e9, layers=80, d_model=8192, chips=16)
    requests = flash_crowd_requests(420, seed=7, base_rps=15.0,
                                    crowd_rps=90.0, crowd_start_s=2.0,
                                    crowd_len_s=3.0, prefix_groups=8)
    fleet = FleetSim(cost=cost, requests=requests, policy=mk_policy(),
                     seq_capacity=1024, slo_ttft_s=0.6, slo_latency_s=4.0,
                     tenant_slo={"batch": 4.0})
    sim = Simulator(board, fleet, timing="atomic")

    events = list(sim.run())
    assert events[-1].kind is ExitEventType.DONE
    for e in events:
        if e.kind in (ExitEventType.SCALE_UP, ExitEventType.SCALE_DOWN):
            print(f"t={e.tick / 1e9:7.3f}s  {e.cause}")

    s = fleet.summary()
    print(f"board              : {board.name}")
    print(f"requests served    : {int(s['requests'])} "
          f"({int(s['tokens_out'])} tokens)")
    print(f"simulated span     : {s['span_s']:.2f} s")
    print(f"throughput/goodput : {s['throughput_rps']:.1f} / "
          f"{s['goodput_rps']:.1f} rps "
          f"({int(s['slo_violations'])} SLO violations)")
    print(f"replicas           : peak {int(s['replicas_peak'])}, "
          f"final {int(s['replicas_final'])} "
          f"({int(s['scale_ups'])} up / {int(s['scale_downs'])} down, "
          f"{s['cold_start_s']:.1f}s cold start)")
    print(f"TTFT p50/p99       : {s['p50_ttft_s'] * 1e3:.1f} / "
          f"{s['p99_ttft_s'] * 1e3:.1f} ms")
    print(f"post-crowd SLO ok  : {fleet.slo_ok_frac(8.0):.2f} "
          "(requests submitted after t=8s)")

    # replay the recorded feed through the controller and compare the
    # decision logs bit for bit
    ctl = FleetController(mk_policy())
    ctl.replay(fleet.feed, requests)
    assert ctl.policy.decisions == fleet.policy.decisions
    print(f"controller replay  : {len(ctl.policy.decisions)} decisions, "
          "identical to the DES log")

    assert s["requests"] == 420, "all requests must complete"
    assert s["scale_ups"] >= 1, "the crowd must trigger a scale-up"
    assert fleet.slo_ok_frac(8.0) >= 0.9, "SLO must recover post-crowd"
    print("fleet smoke OK")


if __name__ == "__main__":
    main()
