"""The MoE dispatch's count/rank kernel K1 (``bcr_thread_counts`` or
``bcr_match`` in the device trace): its bytes a launch at the HBM peak
over its device time."""

from cardbench import work
from cardbench.readers import device_ms


def is_k1(name):
    return "bcr_thread_counts" in name or "bcr_match" in name


def read(ctx):
    per = device_ms(ctx, is_k1)
    if not per or not sum(per):
        return None
    launches = sum(1 for rec in ctx["traced"] for n, _, _ in rec["events"] if is_k1(n))
    c = ctx["config"]
    nbytes = launches * work.count_rank_bytes(work.moe_assignments(c, ctx["traffic"]), c["n_routed_experts"])
    return 100.0 * nbytes / (ctx["hw"].HBM_BYTES_S / 1e3) / sum(per)
