"""Deterministic fault-injection tooling for resilience tests."""
from repro_torch.testing.faults import (CRASH_POINTS, ROTATION_CRASH_POINTS,
                                        FakeClock, Flaky, MalformedRequests,
                                        SimulatedCrash, capacity_flood,
                                        forbid_similarity_kernels,
                                        inject_latency, install_crash,
                                        kill_replica, poison_state)

__all__ = ["CRASH_POINTS", "ROTATION_CRASH_POINTS", "FakeClock", "Flaky",
           "MalformedRequests", "SimulatedCrash", "capacity_flood",
           "forbid_similarity_kernels", "inject_latency", "install_crash",
           "kill_replica", "poison_state"]
