"""AMP op lists (counterpart of ``mxnet_tpu/amp/lists.py``): which ops
compute in the low-precision type (matmul and convolution: the tensor
cores), which stay in f32 (numerically sensitive), which follow their
widest input.  Names the port has no op for yet are kept, so the lists
stay the reference's."""

# matmul and convolution: worth the low precision on the tensor cores
FP16_FP32_FUNCS = TARGET_DTYPE_OPS = [
    "Convolution", "Deconvolution", "FullyConnected", "dot", "batch_dot",
    "matmul",
]

# numerically sensitive: keep fp32
FP32_FUNCS = FP32_OPS = [
    "softmax", "log_softmax", "softmax_cross_entropy", "SoftmaxOutput",
    "BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm", "LRN", "RMSNorm",
    "norm", "mean", "sum", "exp", "log", "erfinv", "CTCLoss",
]

# follow the widest input dtype
WIDEST_TYPE_CASTS = CONDITIONAL_FP32_FUNCS = [
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "concat", "stack", "where",
]

BF16 = "bfloat16"
FP16 = "float16"
