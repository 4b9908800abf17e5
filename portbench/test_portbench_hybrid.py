"""The hybrid family (granite-4.0-h-small): its configuration against the
catalog's published numbers and the port's config, its costs at the cell's
size, the plain reference on small hand cases, and the program's float32
decode held to the reference at `reduced_config`'s size."""

import dataclasses
import json

import pytest
import torch

from portbench import harness
from portbench.ref import hybrid as RH

CAT = harness.Catalog()
hybrid = CAT.module("families", "hybrid")
SERVE = CAT.module("systems", "serve")
CELL = CAT.cell("g4hs-decode-4k")
CFG = CELL["config_file"]
ARCH = "granite-4.0-h-small"
# reduced_config's sizes, in the model's own keys: every mechanism kept
REDUCED = dict(
    hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
    intermediate_size=512, shared_intermediate_size=256,
    num_local_experts=4, num_experts_per_tok=2, vocab_size=1024,
    mamba_n_heads=8, mamba_d_head=64, mamba_d_state=16, mamba_n_groups=2,
    mamba_chunk_size=32, num_hidden_layers=10,
    layer_types=CFG["layer_types"][:10], max_position_embeddings=65536)


def _small(**kw):
    return dict(CFG, **dict(REDUCED, **kw))


def test_the_configuration_is_the_published_one_cut_in_depth_alone():
    from repro_torch.configs.registry import get_config

    assert CELL["config"] == ARCH and CELL["chips"] == 1
    assert CFG["reduced"] == ["num_hidden_layers", "layer_types"]
    assert (CFG["num_hidden_layers"], len(CFG["layer_types"])) == (20, 20)
    assert [i for i, k in enumerate(CFG["layer_types"])
            if k == "attention"] == [5, 15]
    want = dataclasses.replace(get_config(ARCH), n_layers=20)
    assert hybrid.model_config(CFG) == want
    bench = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}[ARCH]
    assert entry["reduced"] == CFG["reduced"]
    assert entry["source"] == CFG["source"]
    assert CFG["engine"] == CAT.cell("g8b-decode-4k")["config_file"][
        "engine"]


def test_the_cells_least_bytes_are_mostly_experts_and_ssd_state():
    """At the cell's size: routed experts 27.2 GB and the f32 SSD state
    read and written 9.7 GB of a step's least bytes (about 42.5 GB)."""
    slots, ctx = 64, [60] * 64
    total = hybrid.step_bytes(CFG, ctx, slots)
    routed = 20 * 72 * 3 * 4096 * 768 * 2
    state = 2 * 18 * 64 * 128 * 128 * 64 * 4
    assert routed == 27_179_089_920 and state == 9_663_676_416
    assert 42.4e9 < total < 42.7e9
    assert (routed + state) / total > 0.85
    assert hybrid.state_row_bytes(CFG) == 2 * 2 * 8 * 128 * 2
    # a token's FLOPs: 2 a weight it multiplies (its 10 experts, not 72),
    # 4 per head-dimension and position attended, 5 per SSD state element
    weights = (2 * 41_943_040 + 18 * 102_236_160 + 4096 * 100352
               + 20 * (4096 * 72 + 10 * 3 * 4096 * 768 + 3 * 4096 * 1536))
    assert hybrid.token_flops(CFG, 60) == (2 * weights + 4 * 2 * 32 * 128 * 60
                                           + 5 * 18 * 128 * 128 * 64)


def test_the_reference_is_causal_and_position_free():
    cfg = _small(num_hidden_layers=4, layer_types=["mamba", "attention"] * 2,
                 hidden_size=64, intermediate_size=32,
                 shared_intermediate_size=48, mamba_n_heads=4,
                 mamba_d_head=16, vocab_size=256)
    p = hybrid.make_weights(cfg, 3, torch.device("cpu"), torch.float32)
    seq = torch.tensor([5, 9, 1, 77, 3, 3, 120])
    full, = RH.forward(cfg, p, [seq])
    part, = RH.forward(cfg, p, [seq[:4]])
    torch.testing.assert_close(full[:4], part, rtol=1e-5, atol=1e-5)
    # two sequences together give each one's logits alone
    other = torch.tensor([8, 8, 2])
    both = RH.forward(cfg, p, [seq, other])
    torch.testing.assert_close(both[0], full, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(both[1], RH.forward(cfg, p, [other])[0],
                               rtol=1e-5, atol=1e-5)
    # NoPE: the last query reads the earlier rows as a set, in any order
    w = {k: v[0].float() for k, v in p["attn"].items()}
    h = torch.randn(5, 64)
    perm = torch.tensor([2, 0, 3, 1, 4])
    out = RH.attention(cfg, w, h, [0], [5])
    torch.testing.assert_close(RH.attention(cfg, w, h[perm], [0], [5])[4],
                               out[4], rtol=1e-5, atol=1e-5)
    assert SERVE.served_gap(full, full.argmax(-1)) == 0.0


def test_the_reference_applies_the_multipliers_where_the_model_does():
    cfg = _small(num_hidden_layers=2, layer_types=["mamba", "attention"],
                 hidden_size=64, intermediate_size=32,
                 shared_intermediate_size=48, mamba_n_heads=4,
                 mamba_d_head=16, vocab_size=256)
    p = hybrid.make_weights(cfg, 4, torch.device("cpu"), torch.float32)
    seq = [torch.tensor([5, 9, 1, 77])]
    base, = RH.forward(cfg, p, seq)
    # logits over logits_scaling
    one, = RH.forward(dict(cfg, logits_scaling=1), p, seq)
    torch.testing.assert_close(one, base * cfg["logits_scaling"])
    # residual multiplier 0: the layers add nothing, the logits are the
    # scaled embedding's through the final norm and the tied head
    none, = RH.forward(dict(cfg, residual_multiplier=0.0), p, seq)
    x = p["embed"][seq[0]] * cfg["embedding_multiplier"]
    want = RH.rms_norm(x, p["final_norm"], cfg["rms_norm_eps"]) \
        @ p["embed"].t() / cfg["logits_scaling"]
    torch.testing.assert_close(none, want, rtol=1e-5, atol=1e-5)
    # with the layers on, the embedding's multiplier and the attention's
    # scale each move the logits
    for key, value in (("embedding_multiplier", 1),
                       ("attention_multiplier", 64.0)):
        moved, = RH.forward(dict(cfg, **{key: value}), p, seq)
        assert not torch.allclose(moved, base, atol=1e-4), key
    # the attention's scores are q.k times attention_multiplier
    w = {k: v[0].float() for k, v in p["attn"].items()}
    h = torch.randn(3, 64)
    hd = 64 // cfg["num_attention_heads"]
    q = (h @ w["wq"]).view(3, 4, hd)
    k = (h @ w["wk"]).view(3, 2, hd).repeat_interleave(2, 1)
    v = (h @ w["wv"]).view(3, 2, hd).repeat_interleave(2, 1)
    s = torch.einsum("qhd,khd->hqk", q, k)[:, 2] * cfg["attention_multiplier"]
    o = torch.einsum("hk,khd->hd", torch.softmax(s, -1), v).reshape(-1)
    torch.testing.assert_close(RH.attention(cfg, w, h, [0], [3])[2],
                               o @ w["wo"], rtol=1e-5, atol=1e-5)


def test_the_float8_control_rounds_each_expert_by_its_columns():
    w = torch.randn(3, 64, 32)
    w[1] *= 100.0  # one expert's scale does not set another's
    q = RH.quantize_fp8(w)
    for e in range(3):
        assert (q[e] - w[e]).abs().max() <= w[e].abs().max(0).values.max() / 8
    assert not torch.equal(q, w)


def test_the_shared_and_routed_experts_equal_the_references_layer():
    from repro_torch.models.layers.moe import MoEDims, moe_block

    cfg = _small()
    p = hybrid.make_weights(cfg, 5, torch.device("cpu"), torch.float32)
    w = {k: v.flatten(0, 1)[3] for k, v in p["moe"].items()}
    h = torch.randn(2, 7, 256, generator=torch.Generator().manual_seed(1))
    got, _ = moe_block(h, w["router"], w["e_gate"], w["e_up"], w["e_down"],
                       MoEDims(4, 4, 2, dropless=True),
                       (w["s_gate"], w["s_up"], w["s_down"]))
    want = RH.experts(cfg, w, h.reshape(14, 256))
    torch.testing.assert_close(got.reshape(14, 256), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [4, 2**31 + 11])
def test_the_programs_float32_decode_matches_the_reference(seed):
    """`Model.decode_step` through the caches, a token at a time, against
    the reference's whole-sequence logits at `reduced_config`'s size, in
    float32: the program's chunked and the reference's sequential SSD sum
    in other orders, as do its batched and the reference's per-expert
    products, so they agree to float32 rounding (2e-4, as the dense
    family's test) and not bit for bit."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.io import init_caches
    from repro_torch.models.registry import build_model

    cfg = _small()
    mcfg = hybrid.model_config(cfg)
    red = reduced_config(ARCH)  # its capacity factor, which dropless skips
    assert mcfg == dataclasses.replace(red, name=ARCH, moe=dataclasses.replace(
        red.moe, capacity_factor=mcfg.moe.capacity_factor))
    p = hybrid.make_weights(cfg, seed, torch.device("cpu"), torch.float32)
    model = build_model(mcfg, compute_dtype=torch.float32, kv_chunk=8,
                        device="cpu")
    caches = init_caches(mcfg, 2, 16, dtype=torch.float32, device="cpu")
    seqs = torch.tensor([[5, 9, 1, 77, 3, 3, 120, 8, 8, 0, 44],
                         [7, 7, 2, 100, 6, 51, 9, 9, 1, 2, 3]])
    got = []
    with torch.no_grad():
        for t in range(seqs.shape[1]):
            at = torch.full((2,), t, dtype=torch.int32)
            lg, caches = model.decode_step(p, caches, seqs[:, t:t + 1], at)
            got.append(lg)
    got = torch.stack(got, 1)
    want = RH.forward(cfg, p, list(seqs))
    for b in range(2):
        torch.testing.assert_close(got[b], want[b], rtol=2e-4, atol=2e-4)
        # the logits are not all alike: the comparison has something to see
        assert float(want[b].std()) > 1e-3


def test_a_cut_down_cell_runs_through_the_serving_system():
    """The cell at a small size on the CPU through `systems/serve.py`, as
    `run.py` runs it traced: every request served from a slot reset at
    admission, the check against the reference correct, and each per-layer
    metric the cell declares read."""
    import time

    cell = CAT.cell("g4hs-decode-4k")
    cell["config_file"].update(REDUCED, num_local_experts=8,
                               vocab_size=4096, mamba_n_groups=1)
    cell["config_file"]["engine"] = dict(batch_size=8, max_seq=64,
                                         kv_chunk=32, sched_window=4)
    cell["mix"].update(requests=64, max_new_tokens=dict(mean=6, max=12),
                       warm_ticks=8)
    run = harness.Run(cell=cell, seed=2**31 + 5, seconds=2.0, trace=True,
                      device=torch.device("cpu"), t0=time.perf_counter(),
                      catalog=CAT)
    out = SERVE.run(run)
    assert out.correct, out.checks
    assert out.record["checked_tokens"] > 0 and out.record["tokens"] > 0
    bench = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
    _, per = harness.cell_metrics(bench, "g4hs-decode-4k")
    read = {m["name"]: CAT.module("metrics", m["name"]).read(out.record)
            for m in per}
    assert "calls_per_tick.serve" in read
    # on the CPU the trace holds no device call: the device readers that
    # divide by device time have nothing to read
    assert {k for k, v in read.items() if v is None} <= {
        "decode_dev_ms.serve", "attn_share.serve", "decode_roofline.serve"}
