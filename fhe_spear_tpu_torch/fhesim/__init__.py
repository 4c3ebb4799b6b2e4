"""fhesim: analytical CKKS accuracy predictor + calibration harness (the
port's own copy; calibration runs on the port's CT-CT column engine)."""

from .simulator import Compatibility, FheAccuracySimulator, SimulatorResult

__all__ = ["FheAccuracySimulator", "Compatibility", "SimulatorResult"]
