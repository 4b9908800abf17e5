"""The decode step's share of its memory roofline: the least bytes the
traced steps need (`portbench.costs.dense_step_bytes`: the weights once,
each active slot's valid K/V prefix once, the new K/V rows, embeddings and
logits once) at 3.35 TB/s, over their device time under the decode
ranges.  Whatever kernels run, the same work is counted."""

from portbench import harness


def read(rec):
    tr = rec.get("trace")
    if not tr or not rec.get("traced_min_bytes"):
        return None
    lab = tr["device_s_by_label"]
    s = lab.get("serve.decode", 0.0) + lab.get("serve.attention", 0.0)
    if s <= 0:
        return None
    return 100.0 * rec["traced_min_bytes"] / harness.PEAK_HBM_BYTES / s
