"""The §7 MSF case study: plant simulator, scenario fleets, detector heads,
model builders and their trainers (``repro.sim``'s counterpart)."""

from repro_torch.sim.detector import (AETrainResult, ScoreTrainResult,
                                      TrainResult, batched_forward,
                                      build_autoencoder, build_detector,
                                      build_forecaster, build_margin_model,
                                      recalibrate_threshold, score_windows,
                                      train_autoencoder, train_detector,
                                      train_forecaster, train_one_class)
from repro_torch.sim.heads import (ClassifierHead, DetectorHead, ForecastHead,
                                   MarginHead, ReconstructionHead, ScoreHead,
                                   conservative_quantile, softmax_np)
from repro_torch.sim.msf import (ATTACK_NAMES, AttackEvent, ParamDrift,
                                 PlantParams, PlantStream, build_dataset,
                                 simulate)
from repro_torch.sim.scenarios import (SCENARIOS, Scenario, build_fleet,
                                       fleet_readings)

__all__ = ["AETrainResult", "ScoreTrainResult", "TrainResult",
           "batched_forward", "build_autoencoder", "build_detector",
           "build_forecaster", "build_margin_model", "recalibrate_threshold",
           "score_windows", "train_autoencoder", "train_detector",
           "train_forecaster", "train_one_class", "ClassifierHead",
           "DetectorHead", "ForecastHead", "MarginHead", "ReconstructionHead",
           "ScoreHead", "conservative_quantile", "softmax_np", "ATTACK_NAMES",
           "AttackEvent", "ParamDrift", "PlantParams", "PlantStream",
           "build_dataset", "simulate", "SCENARIOS", "Scenario",
           "build_fleet", "fleet_readings"]
