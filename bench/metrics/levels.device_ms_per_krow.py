"""Device time of the later cascade levels' kernels (the convolutions,
pooling, dense products, ReLUs and bias adds of models/cnn run by
core/executor outside the fused stage-0 kernel), per 1000 rows scanned in
the traced queries. Kernels are told apart by name."""

NAMES = ("conv", "cudnn", "xmma", "gemm", "cutlass", "max_pool",
         "nchwToNhwc", "nhwcToNchw", "winograd", "implicit", "fft",
         "complex", "flip_filter", "clamp", "CUDAFunctor_add", "sigmoid")


def is_level_kernel(name: str) -> bool:
    return not name.startswith("ps0_") and any(n in name for n in NAMES)


def read(run):
    tr = run.trace
    if tr is None or not tr.rows_scanned:
        return None
    s = sum(v[1] for n, v in tr.time_by_name().items()
            if is_level_kernel(n))
    if s <= 0:
        return None
    return s * 1e3 / (tr.rows_scanned / 1000)
