"""Flash attention's forward share of its roofline over the prompts
served, in %: each request's launches (the window's launches over its
requests) at that prompt's length times one launch's bound
(``bench/work.flash_fwd``: the heads, the length, the head dim, bf16),
summed, over the device time of its kernels (``flash_fwd*``)."""

from bench import work


def read(run):
    launches = run.launches["LAUNCHES"]["flash_attention_fwd"]
    busy, events = run.trace.kernel_s(lambda n: "flash_fwd" in n)
    if not launches or not events or busy <= 0 or not run.units:
        return None
    c = run.cell.config
    per_request = launches / len(run.units)
    bound = 0.0
    for u in run.units:
        flops, nbytes = work.flash_fwd(c["n_heads"], u.work["tokens"], c["head_dim"],
                                       kv_heads_ratio=c["n_kv_heads"] / c["n_heads"])
        bound += per_request * work.bound_s(flops, nbytes, "bfloat16")
    return 100.0 * bound / busy
