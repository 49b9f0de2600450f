"""The plain reference against hand-built cases, and against the port's
own float32 forward pass on the CPU (the test may import the port; the
reference does not)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

import tiny
from benchkit import weights
from reference import transformer as ref


def _np_rope(x, pos, rot, theta):
    half = rot // 2
    out = x.copy()
    for s in range(x.shape[0]):
        for i in range(half):
            a = pos[s] * theta ** (-2.0 * i / rot)
            x1, x2 = x[s, ..., i], x[s, ..., i + half]
            out[s, ..., i] = x1 * math.cos(a) - x2 * math.sin(a)
            out[s, ..., i + half] = x2 * math.cos(a) + x1 * math.sin(a)
    return out


def test_rope_by_hand():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 3, 8)).astype(np.float32)
    pos = np.array([0, 1, 7, 100, 4095])
    got = ref.rope(torch.as_tensor(x), torch.as_tensor(pos), 4, 10000.0)
    np.testing.assert_allclose(got.numpy(), _np_rope(x, pos, 4, 10000.0),
                               rtol=1e-5, atol=1e-5)
    # dims past ``rot`` pass through; position 0 is the identity
    np.testing.assert_array_equal(got.numpy()[..., 4:], x[..., 4:])
    np.testing.assert_allclose(got.numpy()[0], x[0], atol=1e-7)


def test_causal_attention_by_hand():
    rng = np.random.default_rng(1)
    S, H, D = 6, 2, 4
    q, k, v = (rng.normal(size=(S, H, D)).astype(np.float32) for _ in "qkv")
    want = np.zeros((S, H, D), np.float32)
    for h in range(H):
        for i in range(S):
            s = np.array([q[i, h] @ k[j, h] for j in range(i + 1)]) * 0.5
            p = np.exp(s - s.max())
            p /= p.sum()
            want[i, h] = p @ v[:i + 1, h]
    got = ref.causal(ref.Precision("fp32"), *(torch.as_tensor(t)
                                              for t in (q, k, v)), 0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_moe_by_hand():
    """Two experts, one a token, the shared expert zero: each token gets
    its expert's SwiGLU times its softmax probability."""
    d, f = 4, 3
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(5, d)).astype(np.float32))
    p = {"router": torch.as_tensor(rng.normal(size=(d, 2)).astype(np.float32)),
         "wi_gate": torch.randn(2, d, f), "wi_up": torch.randn(2, d, f),
         "wo": torch.randn(2, f, d),
         "shared": {"wi_gate": torch.zeros(d, f), "wi_up": torch.zeros(d, f),
                    "wo": torch.zeros(f, d)}}
    got = ref.moe(ref.Precision("fp32"), p, x, 1)
    probs = torch.softmax(x @ p["router"], -1)
    for t in range(5):
        e = int(probs[t].argmax())
        h = torch.nn.functional.silu(x[t] @ p["wi_gate"][e]) \
            * (x[t] @ p["wi_up"][e])
        torch.testing.assert_close(got[t], probs[t, e] * (h @ p["wo"][e]))


def test_embedding_passthrough_by_hand():
    """With every layer's output projections zero the residual is the
    embedding: logits = LayerNorm(embedding) @ head."""
    cfg = tiny.stablelm()
    params = weights.make_params(cfg, 5, "cpu")
    for leaf in ("wo",):
        params["layers"]["attn"][leaf].zero_()
        params["layers"]["mlp"][leaf].zero_()
    toks = torch.tensor([3, 9, 27])
    got = ref.logits(params, cfg, toks, 1)
    e = params["embed"]["table"][toks[1:]].float().numpy()
    mu, var = e.mean(-1, keepdims=True), e.var(-1, keepdims=True)
    fn = params["final_norm"]
    h = (e - mu) / np.sqrt(var + 1e-5) * fn["scale"].float().numpy() \
        + fn["bias"].float().numpy()
    want = h @ params["lm_head"]["w"].float().numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("make", [tiny.stablelm, tiny.deepseek],
                         ids=["stablelm", "deepseek"])
def test_reference_matches_port_fp32(make):
    """The port's forward in float32 on the CPU, over the same weights,
    gives the reference's logits."""
    from benchkit import program
    from repro_torch.models import make_model
    cfg = make()
    arch = program.arch_config(cfg)
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, dtype="float32", param_dtype="float32"))
    params = weights.make_params(cfg, 11, "cpu")
    p32 = _tree(params, lambda t: t.float())
    toks = torch.as_tensor(np.random.default_rng(4).integers(1, 512, 40))
    with torch.no_grad():
        port, _ = make_model(arch).forward(p32, {"tokens": toks[None]})
    want = ref.logits(p32, cfg, toks, 0)
    torch.testing.assert_close(port[0].float(), want, rtol=2e-4, atol=2e-4)


def test_fp8_control_differs():
    cfg = tiny.stablelm()
    params = weights.make_params(cfg, 5, "cpu")
    toks = torch.arange(1, 30)
    a = ref.logits(params, cfg, toks, 0)
    b = ref.logits(params, cfg, toks, 0, precision="fp8")
    assert (a - b).abs().max() > 1e-2
    with pytest.raises(ValueError):
        ref.Precision("int3")


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    return fn(t)
