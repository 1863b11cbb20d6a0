"""Per-op AMP allow/deny lists (reference: python/paddle/amp/amp_lists.py —
white = compute-bound matmul/conv family run in low precision; black =
numerically sensitive reductions stay fp32)."""

WHITE_LIST = {
    "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose", "matmul", "mm", "bmm", "mv", "linear", "einsum",
    "scaled_dot_product_attention", "flash_attn_bhsd",
}

BLACK_LIST = {
    "exp", "square", "log", "log2", "log10", "log1p", "mean", "sum", "std",
    "var", "cos_sim", "softmax_with_cross_entropy", "cross_entropy",
    "layer_norm", "batch_norm_train", "batch_norm_infer", "group_norm",
    "instance_norm", "softmax", "log_softmax", "norm", "logsumexp",
    "cumsum", "cumprod", "erfinv", "pow", "divide",
}
