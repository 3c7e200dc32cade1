"""SpMV kernels, their wrappers and the dispatch."""


def launch_counters() -> dict:
    """Kernel name -> (module, attribute) of its wrapper's launch count."""
    from ellspmv_tpu_torch.ops import (dia_cuda, dot_cuda, ell_cuda, permute,
                                       stream_sum, symgs_cuda)
    return {"ell_spmv": (ell_cuda, "launches"),
            "dia_spmv": (dia_cuda, "launches"),
            "dia_symgs": (symgs_cuda, "launches"),
            "fma_probe": (ell_cuda, "probe_launches"),
            "dot": (dot_cuda, "launches"), "permute": (permute, "launches"),
            "stream_sum": (stream_sum, "launches"),
            "stream_sum_src": (stream_sum, "src_launches")}
