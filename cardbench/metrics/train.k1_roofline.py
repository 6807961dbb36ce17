"""The MoE dispatch's count/rank kernel K1 (``bcr_thread_counts`` or
``bcr_match`` in the device trace): its bytes a launch at the HBM peak
over its device time.  Its buckets are the routed experts, all that a
share's router routes over (``shares.n_routed_experts.published``)."""

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
    share = c.get("shares", {}).get("n_routed_experts")  # a rank ranks into every published expert
    buckets = share["published"] if share else c["n_routed_experts"]
    nbytes = launches * work.count_rank_bytes(work.moe_assignments(c, ctx["traffic"]), buckets)
    return 100.0 * nbytes / (ctx["hw"].HBM_BYTES_S / 1e3) / sum(per)
