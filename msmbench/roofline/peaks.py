"""Published peaks of one NVIDIA H100 SXM (NVIDIA H100 Tensor Core GPU
data sheet, dense rates without sparsity, at the full 700 W): the
roofline shares are stated against these, with the card's power limit
beside each result."""

TF32_FLOPS = 495e12     # TF32 tensor-core products
FP32_FLOPS = 67e12      # float32 outside the tensor cores
HBM_BYTES = 3.35e12     # HBM3 bandwidth, bytes a second
