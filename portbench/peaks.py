"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity), the denominators of every roofline and ``mfu`` share:
67 TFLOP/s in float32 outside the tensor cores and 3.35 TB/s of HBM (80 GB).
The tensor cores' rates (495 TFLOP/s TF32, 989 bf16) apply to no step that
the benchmark measures: every step it counts runs in float32 off them.

The rates assume the card's full power limit of 700 W.  A card may be set
below it; every result line carries the limit that ``nvidia-smi`` reads
(``device.power_limit_w``), so a share is always read beside it.
"""

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
