"""Flash attention's backward share of its roofline, in %: the bound of
one launch at the step's shape (``bench/work.flash_bwd``: B·H folded
heads, the sequence, the head dim, bf16) times the launches in the
traced window, over the device time of its kernels (``flash_bwd_*``)."""

from bench import work


def read(run):
    launches = run.launches["LAUNCHES"]["flash_attention_bwd"]
    busy, events = run.trace.kernel_s(lambda n: "flash_bwd" in n)
    if not launches or not events or busy <= 0:
        return None
    c, t = run.cell.config, run.cell.traffic
    flops, nbytes = work.flash_bwd(t["batch"] // t["microbatches"] * c["n_heads"],
                                   t["seq"], c["head_dim"],
                                   kv_heads_ratio=c["n_kv_heads"] / c["n_heads"])
    return 100.0 * launches * work.bound_s(flops, nbytes, "bfloat16") / busy
