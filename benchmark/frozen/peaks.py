"""Data-sheet peaks of one NVIDIA H100 SXM (dense, no sparsity, at the full
700 W power limit).

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``FP32_NON_FMA_PER_S``,
``FP32_FMA_FLOP_PER_S``, ``BF16_FLOP_PER_S``) at commit
78531ab. fp32 67 TFLOP/s counts an FMA as two operations, so plain fp32
adds, subtracts and mins run at half that: 132 SMs x 128 lanes x 1.98 GHz.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_NON_FMA_PER_S = 132 * 128 * 1.98e9
FP32_FMA_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
