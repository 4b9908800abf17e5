"""The port-only architecture granite-4.0-h-small (`configs/
granite_4_0_h_small.py`) and the mechanisms it added to the port, on the
CPU at small sizes: the config and its counts, dropless routing, the
shared expert, Mamba-2's gated norm in the chunked forward and the decode
step, and an engine slot recycled with its SSD state reset.  The decode
against the plain reference (`portbench/ref/hybrid.py`) is in
`portbench/test_portbench_hybrid.py`.  Nothing here has a JAX
counterpart."""

import dataclasses

import pytest
import torch

from repro_torch.configs.base import port_only_changes
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core.classifier.dataset import make_training_set
from repro_torch.core.classifier.tree import train_tree
from repro_torch.models import params as TP
from repro_torch.models.layers import moe as TM
from repro_torch.models.layers import ssm as TS
from repro_torch.models.layers.mlp import gated_mlp, silu
from repro_torch.models.params import init_params
from repro_torch.models.registry import build_model
from repro_torch.serve import EngineConfig, Request, ServeEngine

ARCH = "granite-4.0-h-small"


@pytest.fixture(scope="module")
def tree():
    return train_tree(*make_training_set(), 4, max_depth=8)


def test_the_config_is_the_published_one_and_counts_its_shared_expert():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.hybrid_period, cfg.hybrid_attn_pos) == (40, 10,
                                                                      5)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.d_ff,
            cfg.moe.shared_d_ff) == (72, 10, 768, 1536)
    assert (cfg.ssm.d_inner // cfg.ssm.head_dim, cfg.ssm.d_state,
            cfg.ssm.n_groups) == (128, 128, 1)
    assert sorted(port_only_changes(cfg)) == sorted([
        "MoEConfig.dropless", "MoEConfig.shared_d_ff", "SSMConfig.gated_norm",
        "ModelConfig.norm_eps", "ModelConfig.rope", "ModelConfig.attn_scale",
        "ModelConfig.embed_multiplier", "ModelConfig.residual_multiplier",
        "ModelConfig.logits_divisor"])
    # the benchmark's 20-layer cut: 18 SSD layers of 102.2 M, 20 MoE layers
    # of 679.8 M (experts and router) and 18.9 M (shared), 2 attention
    # layers of 41.9 M and a 411.0 M tied embedding
    cut = dataclasses.replace(cfg, n_layers=20)
    assert cut.param_count() == (18 * 102_236_160 + 20 * 679_772_160
                                 + 20 * 18_874_368 + 2 * 41_943_040
                                 + 411_041_792) == 16_308_109_312
    routed = 20 * 72 * 3 * 4096 * 768
    assert cut.active_param_count() == cut.param_count() - routed \
        + routed * 10 // 72
    # the reduced model keeps every mechanism, at its small size
    red = reduced_config(ARCH)
    assert sorted(port_only_changes(red)) == sorted(port_only_changes(cfg))
    assert red.moe.shared_d_ff and red.n_layers == red.hybrid_period == 10


def test_every_position_of_the_hybrid_has_moe_and_no_dense_ffn():
    cfg = reduced_config(ARCH)
    layout = TP.param_layout(cfg)
    assert "mlp" not in layout
    assert layout["moe"]["e_gate"][0][:2] == (1, 10)
    assert layout["moe"]["s_down"][0] == ((1, 10, 256, 256))
    assert layout["ssm"]["out_norm"][0] == (1, 9, 512)
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    calls = []
    model._moe_ffn = lambda x, p: (calls.append(1), (x, None))[1]
    model._ffn = lambda x, p: pytest.fail("a dense FFN in the hybrid")
    params = init_params(cfg, device="cpu", dtype=torch.float32)
    from repro_torch.models.io import init_caches

    caches = init_caches(cfg, 2, 8, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        model.decode_step(params, caches, torch.ones((2, 1), dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32))
    assert len(calls) == 10


def _experts(E, D, F, g):
    return [torch.randn(E, D, F, generator=g) * 0.3,
            torch.randn(E, D, F, generator=g) * 0.3,
            torch.randn(E, F, D, generator=g) * 0.3]


def _direct(x, router, w, K):
    """Each token through its own top K experts (softmax over all, top K
    renormalised), no capacity."""
    probs = torch.softmax(x @ router, -1)
    val, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    val = val[:, :K] / val[:, :K].sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for k in range(K):
            e = int(sel[t, k])
            out[t] += val[t, k] * (silu(x[t] @ w[0][e]) * (x[t] @ w[1][e])) \
                @ w[2][e]
    return out


def test_dropless_keeps_every_assignment_when_all_tokens_pick_one_expert():
    g = torch.Generator().manual_seed(0)
    T, D, F, E, K = 12, 8, 6, 4, 2
    x = torch.rand(1, T, D, generator=g) + 0.1  # all positive
    router = torch.randn(D, E, generator=g) * 0.1
    router[:, 0] += 5.0  # every token's first choice is expert 0
    w = _experts(E, D, F, g)
    dims = TM.MoEDims(E, E, K, capacity_factor=1.25, dropless=True)
    assert TM.capacity(T, dims) == T
    out, _ = TM.moe_block(x, router, *w, dims)
    torch.testing.assert_close(out[0], _direct(x[0], router, w, K),
                               rtol=1e-5, atol=1e-5)
    # with a capacity, expert 0 keeps int(12 * 2 / 4 * 1.25) = 7 of 12
    capped, _ = TM.moe_block(x, router, *w, dataclasses.replace(
        dims, dropless=False))
    assert not torch.allclose(capped, out, atol=1e-3)


def test_shared_expert_adds_to_the_routed_output():
    g = torch.Generator().manual_seed(1)
    T, D, F, Fs, E, K = 10, 8, 6, 5, 4, 2
    x = torch.randn(2, T // 2, D, generator=g)
    router = torch.randn(D, E, generator=g)
    w = _experts(E, D, F, g)
    shared = [torch.randn(D, Fs, generator=g), torch.randn(D, Fs, generator=g),
              torch.randn(Fs, D, generator=g)]
    dims = TM.MoEDims(E, E, K, dropless=True)
    routed, aux = TM.moe_block(x, router, *w, dims)
    both, aux2 = TM.moe_block(x, router, *w, dims, shared)
    torch.testing.assert_close(both, routed + gated_mlp(x, *shared))
    assert aux2 == aux
    torch.testing.assert_close(
        both.reshape(T, D), _direct(x.reshape(T, D), router, w, K)
        + gated_mlp(x, *shared).reshape(T, D), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("G", [1, 2])
def test_gated_norm_chunked_forward_and_decode_step_agree(G):
    """The chunked forward's outputs and final state against the step-by-
    step decode from zero state, with the gated norm (f32: only the sums'
    order differs, 1e-5)."""
    g = torch.Generator().manual_seed(2)
    dims = TS.SSMDims(d_model=16, d_inner=32, head_dim=8, d_state=4,
                      n_groups=G, chunk=4, gated_norm=True, norm_eps=1e-5)
    B, S = 2, 8
    H, C = dims.n_heads, dims.conv_channels
    p = {"in_proj": torch.randn(16, dims.in_proj_out, generator=g) * 0.3,
         "conv_w": torch.randn(4, C, generator=g) * 0.3,
         "conv_b": torch.randn(C, generator=g) * 0.1,
         "A_log": torch.log(torch.arange(1.0, H + 1)),
         "dt_bias": torch.randn(H, generator=g) * 0.1,
         "D": torch.ones(H),
         "out_proj": torch.randn(32, 16, generator=g) * 0.3,
         "out_norm": torch.randn(32, generator=g) * 0.1}
    x = torch.randn(B, S, 16, generator=g)
    y, h_last, tail = TS.ssd_forward(x, p, dims)
    st = TS.SSMState(h=torch.zeros(B, H, 4, 8), conv=torch.zeros(B, 3, C))
    steps = []
    for t in range(S):
        yt, st = TS.ssd_decode_step(x[:, t:t + 1], st, p, dims)
        steps.append(yt)
    torch.testing.assert_close(torch.cat(steps, 1), y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st.h, h_last, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st.conv, tail)
    # the gate alone (no norm) gives another output
    plain, _, _ = TS.ssd_forward(x, p, dataclasses.replace(dims,
                                                           gated_norm=False))
    assert not torch.allclose(plain, y, atol=1e-3)


def _logits_by_uid(eng):
    """Wrap the engine's decode: each active slot's logits by its uid."""
    out = {}
    decode = eng._decode

    def logged(*a):
        logits, caches = decode(*a)
        for i, r in enumerate(eng.active):
            if r is not None:
                out.setdefault(r.uid, []).append(logits[i].clone())
        return logits, caches

    eng._decode = logged
    return out


@pytest.mark.parametrize("reset", [True, False])
def test_a_recycled_slot_gives_a_fresh_slots_logits(tree, reset):
    """One slot serves two requests in turn; the second's logits equal
    those of the same request in a fresh engine, bit for bit (f32), when
    the engine zeroes an admitted slot's SSD state, and differ when it
    keeps the predecessor's (`reset_ssm_state` off, the reference's)."""
    cfg = reduced_config(ARCH)
    params = init_params(cfg, torch.Generator().manual_seed(5),
                         dtype=torch.float32, device="cpu")
    for k in ("conv_b", "out_norm", "norm"):  # exercise every leaf
        params["ssm"][k] = torch.randn(params["ssm"][k].shape,
                                       generator=torch.Generator()
                                       .manual_seed(6)) * 0.1
    reqs = [Request(uid=3, prompt_len=4, max_new_tokens=5),
            Request(uid=8, prompt_len=4, max_new_tokens=4)]

    def engine(ecfg_reset):
        with pytest.MonkeyPatch.context() as mp:
            import repro_torch.models.io as TIO
            import repro_torch.models.registry as TMR
            import functools

            mp.setattr(TMR, "build_model", functools.partial(
                TMR.build_model, compute_dtype=torch.float32))
            mp.setattr(TIO, "init_caches", functools.partial(
                TIO.init_caches, dtype=torch.float32))
            return ServeEngine(cfg, params, EngineConfig(
                batch_size=1, max_seq=16, eos_token=-1,
                reset_ssm_state=ecfg_reset), device="cpu", tree=tree)

    eng = engine(reset)
    seen = _logits_by_uid(eng)
    res = eng.run([[dataclasses.replace(r) for r in reqs]], max_steps=30)
    assert res["completed"] == 2
    second = max(eng.admit_step, key=eng.admit_step.get)
    fresh = engine(True)
    alone = _logits_by_uid(fresh)
    fresh.run([[dataclasses.replace(r) for r in reqs if r.uid == second]],
              max_steps=30)
    a, b = torch.stack(seen[second]), torch.stack(alone[second])
    assert torch.equal(a, b) == reset
    m = eng.obs.metrics.value("engine.ssm_state_resets")
    assert m == (2 if reset else 0)
