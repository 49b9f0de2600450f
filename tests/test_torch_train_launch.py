"""The port's training entry points on the CPU: ``python -m
repro_torch.launch.train`` in ``flat`` and ``hfl`` modes at the reduced
gemma3-1b (its default arch), 2 steps, with a checkpoint that loads back
through ``load_pytree``; ``examples/train_lm_hfl_torch.py --compress`` at
the reduced xlstm-125m (its default).  Losses are finite and the printed
lines keep the reference's format.  ``make_batch`` gives the reference's
tokens and its bf16 vlm / audio stubs, bit for bit."""
import importlib.util
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import load_pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import TokenStream, TokenStreamConfig  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.params import flatten_with_path  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = r"-?\d+\.\d+"
LOSSES = rf"\[{NUM}(, {NUM})*\]"


def test_flat_mode_trains_and_checkpoints(tmp_path, capsys):
    ck = str(tmp_path / "flat")
    out = train.main(["--device", "cpu", "--mode", "flat", "--steps", "2",
                      "--checkpoint", ck])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "arch=gemma3-1b (reduced=True) params..."
    for t, line in enumerate(lines[1:3]):
        assert re.fullmatch(rf"step {t:3d} loss={NUM} \({NUM}s\)", line)
    assert lines[3] == f"checkpoint -> {ck}"
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 2
    back = load_pytree(ck, out["params"])
    for (p, a), (_, b) in zip(flatten_with_path(back),
                              flatten_with_path(out["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_hfl_mode_syncs_every_l_rounds(tmp_path, capsys):
    ck = str(tmp_path / "hfl.npz")
    out = train.main(["--device", "cpu", "--steps", "2", "--checkpoint",
                      ck])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(rf"round   0 losses={LOSSES} \({NUM}s\)", lines[1])
    assert re.fullmatch(rf"round   1 losses={LOSSES} \({NUM}s\)  "
                        rf"\[GLOBAL SYNC, divergence was "
                        rf"\d\.\d\de[+-]\d\d\]", lines[2])
    assert np.isfinite(out["losses"]).all()
    assert np.array(out["losses"]).shape == (2, 2)       # steps x clusters
    back = load_pytree(ck, out["params"])
    for (p, a), (_, b) in zip(flatten_with_path(back),
                              flatten_with_path(out["params"])):
        assert torch.equal(a, b), p
    # the driver trains gemma3's reduced config (2 layers), bf16
    assert out["params"]["layers"]["attn"]["wq"].shape[0] == 2
    assert {str(x.dtype) for _, x in flatten_with_path(out["params"])} == \
        {"torch.bfloat16"}


def test_example_trains_with_int8_sync(capsys):
    spec = importlib.util.spec_from_file_location(
        "train_lm_hfl_torch", os.path.join(ROOT, "examples",
                                           "train_lm_hfl_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = example.main(["--device", "cpu", "--steps", "2", "--compress"])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"xlstm-125m: \d+\.\dM params, 2 clusters, global "
                        r"sync every 2 rounds, compress=True", lines[0])
    assert re.fullmatch(rf"round   0 losses={LOSSES} \({NUM}s\)", lines[1])
    assert re.fullmatch(rf"round   1 losses={LOSSES} \({NUM}s\) \[GLOBAL "
                        rf"SYNC: divergence \d\.\d\de[+-]\d\d, payload "
                        rf"{NUM} MB/cluster\]", lines[2])
    assert np.isfinite(out["losses"]).all()
    # after the sync the clusters hold one model
    for p, x in flatten_with_path(out["stacked"]):
        assert torch.equal(x[0], x[1]), p


@pytest.mark.parametrize("arch,clusters", [("internvl2-76b", 2),
                                           ("whisper-small", 0),
                                           ("gemma3-1b", 3)])
def test_make_batch_matches_the_reference(arch, clusters):
    pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.data.tokens import TokenStream as JaxStream
    from repro.data.tokens import TokenStreamConfig as JaxStreamConfig
    from repro.launch.train import make_batch as jax_make_batch
    cfg = get_config(arch).reduced()
    kw = dict(vocab_size=cfg.model.vocab_size, seq_len=8, batch_size=2)
    got = train.make_batch(TokenStream(TokenStreamConfig(**kw)), cfg, 2, 8,
                           clusters=clusters, device="cpu")
    want = jax_make_batch(JaxStream(JaxStreamConfig(**kw)),
                          jax_get_config(arch).reduced(), 2, 8,
                          clusters=clusters)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        w = np.asarray(v)
        assert tuple(got[k].shape) == w.shape, k
        if w.dtype.name == "bfloat16":
            assert got[k].dtype == torch.bfloat16
            assert np.array_equal(got[k].view(torch.int16).numpy(),
                                  w.view(np.int16)), k
        else:
            assert np.array_equal(got[k].numpy(), w), k
