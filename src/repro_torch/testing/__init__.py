"""Deterministic fault-injection tooling for resilience tests (the crash
half of ``repro.testing``)."""
from repro_torch.testing.faults import (CRASH_POINTS, ROTATION_CRASH_POINTS,
                                        FakeClock, Flaky, SimulatedCrash,
                                        install_crash)

__all__ = ["CRASH_POINTS", "ROTATION_CRASH_POINTS", "FakeClock", "Flaky",
           "SimulatedCrash", "install_crash"]
