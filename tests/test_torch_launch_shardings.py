"""``repro_torch.launch.shardings`` against ``repro.launch.shardings``:
for every assigned architecture at full width, each parameter's DTensor
placements, read back as the mesh axes of each tensor dim, equal the
reference's ``PartitionSpec`` on an ``AbstractMesh`` of the same sizes,
and one rank's parameter bytes equal the sum of the reference's
``shard_shape``s.  Meshes: the reference's (16, 16) and (2, 16, 16), its
HFL (4, 4, 16), and the port's production (32, 8) and (2, 32, 8).  No
device and no process group is needed: the port sizes shardings from
axis sizes alone."""
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import ASSIGNED  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch.specs import param_specs_and_axes  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.models.common import axes_to_placements, placements_for  # noqa: E402

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "hfl_4x4x16": {"cluster": 4, "data": 4, "model": 16},
    "32x8": {"data": 32, "model": 8},
    "2x32x8": {"pod": 2, "data": 32, "model": 8},
}


def _flat(tree, pre=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], pre + (k,))
    else:
        yield pre, tree


@functools.lru_cache(maxsize=None)
def _reference(arch):
    from repro.configs import get_config as jax_config
    from repro.launch.specs import param_specs_and_axes as ref_specs
    from repro.models import make_model as jax_model
    return ref_specs(jax_model(jax_config(arch)))


@functools.lru_cache(maxsize=None)
def _port(arch):
    return param_specs_and_axes(make_model(get_config(arch)))


def _local_shape(shape, sizes, placements):
    """One rank's shape: each split dim divided by its axes' sizes,
    rounded up as DTensor's first chunk is."""
    out = list(shape)
    for size, p in zip(sizes.values(), placements):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // size)
    return out


def _axes_per_dim(placements, names, ndim):
    out = [()] * ndim
    for name, p in zip(names, placements):
        if isinstance(p, Shard):
            out[p.dim] = out[p.dim] + (name,)
    return out


def _spec_per_dim(spec, ndim):
    out = []
    for i in range(ndim):
        e = spec[i] if i < len(spec) else None
        out.append(() if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_placements_equal_the_references_specs(arch, mesh):
    from jax.sharding import AbstractMesh
    from repro.launch import shardings as ref
    sizes = MESHES[mesh]
    amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    want_p, want_ax = _reference(arch)
    got_p, got_ax = _port(arch)
    want = dict(_flat(ref.params_shardings(want_ax, want_p, amesh,
                                           ref.DEFAULT_RULES)))
    got = dict(_flat(sh.params_shardings(got_ax, got_p, sizes,
                                         sh.DEFAULT_RULES)))
    assert set(got) == set(want)
    shapes = dict(_flat(want_p))
    local_bytes = want_bytes = 0
    for path, ns in want.items():
        x = shapes[path]
        assert len(got[path]) == len(sizes)
        assert _axes_per_dim(got[path], list(sizes), x.ndim) == \
            _spec_per_dim(ns.spec, x.ndim), path
        item = x.dtype.itemsize
        want_bytes += int(np.prod(ns.shard_shape(x.shape))) * item
        local_bytes += int(np.prod(_local_shape(x.shape, sizes,
                                                got[path]))) * item
    assert local_bytes == want_bytes


@pytest.mark.parametrize("mesh", ["2x16x16", "hfl_4x4x16"])
def test_batch_and_cache_placements_equal_the_references(mesh):
    """Batch specs of the LM families and the decode caches of a dense
    and an MLA config (the port's ring index stays replicated, as the
    reference's scalar does)."""
    import jax
    from jax.sharding import AbstractMesh
    from repro.configs import get_config as jax_config
    from repro.launch import shardings as ref
    from repro.launch import specs as ref_specs
    from repro.models import make_model as jax_model
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import specs
    sizes = MESHES[mesh]
    amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    for arch in ("stablelm-1.6b", "internvl2-76b", "whisper-small"):
        shape = INPUT_SHAPES["train_4k"]
        jb = ref_specs.model_batch_specs(jax_config(arch), shape)
        tb = specs.model_batch_specs(get_config(arch), shape)
        want = ref.batch_shardings(jb, amesh, ref.DEFAULT_RULES)
        got = sh.batch_shardings(tb, sizes, sh.DEFAULT_RULES)
        for k in want:
            assert _axes_per_dim(got[k], list(sizes), tb[k].ndim) == \
                _spec_per_dim(want[k].spec, tb[k].ndim), (arch, k)
    for arch in ("stablelm-1.6b", "deepseek-v2-lite-16b"):
        jc = ref_specs.cache_specs(jax_model(jax_config(arch)), 128, 32768)
        tc = specs.cache_specs(make_model(get_config(arch)), 128, 32768)
        want = jax.tree_util.tree_flatten_with_path(
            ref.cache_shardings(jc, amesh, ref.DEFAULT_RULES))[0]
        got = sh.cache_shardings(tc, sizes, sh.DEFAULT_RULES)
        got_flat = {}
        for part, sub in got.items():
            for name, node in (sub.items() if isinstance(sub, dict)
                               else [(None, sub)]):
                for field, pls in zip(node._fields, node):
                    got_flat[(part, name, field)] = pls
        for path, ns in want:
            keys = [getattr(k, "key", getattr(k, "name", None))
                    for k in path]
            part, field = keys[0], keys[-1]
            name = keys[1] if len(keys) == 3 else None
            pls = got_flat[(part, name, field)]
            ndim = len(tc[part][name]._asdict()[field].shape) if name \
                else len(getattr(tc[part], field).shape)
            if field == "index":
                assert all(p == Replicate() for p in pls)
                continue
            assert _axes_per_dim(pls, list(sizes), ndim) == \
                _spec_per_dim(ns.spec, ndim), (arch, keys)


def test_split_over_axes_out_of_mesh_order_raises():
    """A rule that lists its mesh axes against the mesh's order would
    split a dim in another order than the reference: it raises."""
    sizes = {"pod": 2, "data": 4, "model": 2}
    assert axes_to_placements(sizes, [("pod", "data"), None]) == (
        Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="not in the mesh's order"):
        axes_to_placements(sizes, [("data", "pod"), None])
    with pytest.raises(ValueError, match="not in the mesh's order"):
        placements_for(sizes, {"batch": ("data", "pod")}, ("batch",), (8,))
