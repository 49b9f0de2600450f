"""The dry-run specs of ``repro_torch.launch.specs`` against the JAX
package's ``repro.launch.specs``, for every assigned architecture at
full width: each parameter leaf's shape, dtype and logical axes key for
key, the batch specs of every applicable shape, and the decode cache
specs (field names, shapes, dtypes).  Fake tensors and
``jax.eval_shape`` allocate nothing.  The one documented difference: a
port ring cache keeps its ``index`` per batch row, (B,) after the
reference's shape, where the reference keeps a scalar."""
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.configs import applicable_shapes, get_config  # noqa: E402
from repro_torch.configs.registry import ASSIGNED  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models.common import count_params, param_bytes  # noqa: E402


def _flat(tree, pre=()):
    """(path, leaf) pairs of nested dicts and NamedTuples, the tuples of
    a logical-axes tree kept as leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], pre + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _flat(v, pre + (f,))
    else:
        yield pre, tree


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _ref(arch):
    from repro.configs import get_config as jax_config
    from repro.models import make_model as jax_model
    return jax_config(arch), jax_model(jax_config(arch))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_specs_and_axes_equal_the_references(arch):
    from repro.launch.specs import param_specs_and_axes as ref_specs
    from repro.models.common import count_params as ref_count
    _, japi = _ref(arch)
    want_p, want_ax = ref_specs(japi)
    got_p, got_ax = specs.param_specs_and_axes(make_model(get_config(arch)))
    want = {p: (tuple(x.shape), str(x.dtype)) for p, x in _flat(want_p)}
    got = {p: (tuple(x.shape), _dtype(x)) for p, x in _flat(got_p)}
    assert got == want
    assert dict(_flat(got_ax)) == {p: tuple(a) for p, a in _flat(want_ax)}
    assert all(isinstance(x, torch._subclasses.FakeTensor)
               for _, x in _flat(got_p))
    assert count_params(got_p) == ref_count(want_p)
    assert param_bytes(got_p) == sum(
        x.size * x.dtype.itemsize for _, x in _flat(want_p))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_batch_and_cache_specs_equal_the_references(arch):
    from repro.launch import specs as ref
    jcfg, japi = _ref(arch)
    cfg = get_config(arch)
    api = make_model(cfg)
    for shape in applicable_shapes(cfg):
        if shape.mode == "decode":
            want = {p: (tuple(x.shape), str(x.dtype)) for p, x in _flat(
                ref.cache_specs(japi, shape.global_batch, shape.seq_len))}
            got = {p: (tuple(x.shape), _dtype(x)) for p, x in _flat(
                specs.cache_specs(api, shape.global_batch, shape.seq_len))}
            for p, (shp, dt) in want.items():
                if p[-1] == "index":   # the port's per-row ring index
                    want[p] = (shp + (shape.global_batch,), dt)
            assert got == want, shape.name
            tok, pos = specs.decode_token_specs(cfg, shape)
            jtok, jpos = ref.decode_token_specs(jcfg, shape)
            assert (tuple(tok.shape), _dtype(tok), tuple(pos.shape)) == (
                tuple(jtok.shape), str(jtok.dtype), tuple(jpos.shape))
        else:
            train = shape.mode == "train"
            want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                    ref.model_batch_specs(jcfg, shape, train).items()}
            got = {k: (tuple(v.shape), _dtype(v)) for k, v in
                   specs.model_batch_specs(cfg, shape, train).items()}
            assert got == want, shape.name
