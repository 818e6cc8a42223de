"""The §7 case-study detector workloads: the paper's densely connected
classifier (400 inputs = 2 features x 10 readings/s x 20 s, hidden ReLU
layers, 2-class head) plus the unsupervised autoencoder variant — and the
serving-side constants for the fleet detection service
(`repro_torch.serving.streams.StreamEngine`)."""

INPUT_SIZE = 400
HIDDEN = (64, 32, 16)
CLASSES = 2

# Unsupervised reconstruction detector: 400-64-16-64-400 autoencoder trained
# on benign windows only (MSE), anomaly score = per-window reconstruction
# error.  The verdict threshold is calibrated to AE_TARGET_FPR false
# positives on held-out normal traces (sim.detector.train_autoencoder).
AE_HIDDEN = (64, 16, 64)
AE_TARGET_FPR = 0.01

# One-class margin detector (Deep-SVDD-style): the §7 trunk embedding
# windows into MARGIN_EMBED dims; anomaly score = squared distance from the
# benign center, threshold = FPR-calibrated margin radius.
MARGIN_EMBED = 16

# Next-step-prediction detector: (WINDOW - 1) readings in, one reading out
# (the ForecastHead asks the serving ring for the extra target reading).
FORECAST_HIDDEN = (64, 32)
WINDOW_SECONDS = 20
READINGS_PER_SECOND = 10
N_FEATURES = 2
SCAN_CYCLE_MS = 100

# Sliding-window featurization (shared by build_dataset and StreamEngine):
# window length in scan cycles and the verdict stride between windows.
WINDOW = WINDOW_SECONDS * READINGS_PER_SECOND   # 200 readings -> 400 features
STRIDE = 10

# PLC-side normalization around the nominal operating point — baked into data
# collection by the paper's porting flow, so serving must apply the identical
# transform: (reading - NORM_MEAN) / NORM_STD per feature (TB0, Wd).
NORM_MEAN = (89.6, 19.18)
NORM_STD = (2.0, 0.5)

# Fleet serving defaults: verdicts must land within one scan cycle of the
# window completing (the §7 real-time budget), across this many plants.
DEADLINE_S = SCAN_CYCLE_MS / 1000.0
FLEET_STREAMS = 16

# Stream-axis sharding: per-device shard of the fleet arena used by the
# device-scaling benchmark rows (a d-device mesh serves d x this many
# plants; benchmarks/detection_bench.py --shard-worker).
STREAMS_PER_DEVICE = 128
