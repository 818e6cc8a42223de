"""The paper's own benchmark model family (§5.2): 64-in/64-out dense stacks
with ReLU, plus the §6 quantization/pruning layers."""

BENCH_FEATURES = 64          # §5.2 layer-stacking benchmark width
QUANT_LAYER = (512, 512)     # §6.1 isolated hidden layer (Table 2, Fig. 5)
PRUNE_LAYER = (784, 512)     # §6.2 pruning experiments
