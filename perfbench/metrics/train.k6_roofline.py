"""K6's share of its roofline: the least time of the window's K6 launches
(dKe and dKp; `perfbench/counts/kernels.py`, from each batch's valid node
and edge counts) over the device time of `assoc_grad_kernel`."""
LAYER = "kernels"
MOVES = "train_pairs_per_s"
UNIT = "%"
KERNEL = "assoc_grad_kernel"


def read(ctx):
    t = ctx.get("trace")
    bound = ctx["work"].get("kernel_bound_s", {}).get(KERNEL)
    if not t or not bound:
        return None
    spent = sum(s for n, (_, s) in t["by_name"].items() if KERNEL in n)
    return 100.0 * bound / spent if spent else None
