"""The §7 MSF case study: plant simulator, scenario fleets, detector heads
and model builders (``repro.sim``'s counterpart)."""

from repro_torch.sim.detector import (batched_forward, build_autoencoder,
                                      build_detector, build_forecaster,
                                      build_margin_model)
from repro_torch.sim.heads import (ClassifierHead, DetectorHead, ForecastHead,
                                   MarginHead, ReconstructionHead, ScoreHead,
                                   conservative_quantile, softmax_np)
from repro_torch.sim.msf import (ATTACK_NAMES, AttackEvent, ParamDrift,
                                 PlantParams, PlantStream, build_dataset,
                                 simulate)
from repro_torch.sim.scenarios import (SCENARIOS, Scenario, build_fleet,
                                       fleet_readings)

__all__ = ["batched_forward", "build_autoencoder", "build_detector",
           "build_forecaster", "build_margin_model", "ClassifierHead",
           "DetectorHead", "ForecastHead", "MarginHead", "ReconstructionHead",
           "ScoreHead", "conservative_quantile", "softmax_np", "ATTACK_NAMES",
           "AttackEvent", "ParamDrift", "PlantParams", "PlantStream",
           "build_dataset", "simulate", "SCENARIOS", "Scenario",
           "build_fleet", "fleet_readings"]
