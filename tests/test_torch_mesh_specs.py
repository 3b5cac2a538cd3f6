"""The training half of the port's ``distributed/sharding.py`` and its
``launch/mesh.py`` against the reference's: ``param_specs`` (both
layouts), ``opt_specs``, ``batch_specs`` and ``cache_specs`` leaf by leaf
for every registered config's smoke tree on 2x2, 4x1 and 1x4 meshes (the
reference's meshes over the 4 host devices ``tests/conftest.py`` forces;
the port's layer lists take the reference's stacked spec without its
leading entry), ``sanitize``'s refusals with the reference's messages,
and a rank's blocks (``shard_tree``) against the reference's
``addressable_shards`` of the same placement. No process group: the
specs read a mesh's shape only."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from repro import configs as rconfigs
from repro.distributed import sharding as rsharding
from repro.models import model as rmodel
from repro.optim import adamw as radamw
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw as tadamw

ARCHS = tconfigs.names()
SHAPES = ((2, 2), (4, 1), (1, 4))


def _ref_mesh(shape):
    return Mesh(np.asarray(jax.devices()[:4]).reshape(shape),
                ('data', 'model'))


def _port_mesh(shape, rank=None):
    return tmesh.shape_mesh(dict(data=shape[0], model=shape[1]), rank)


def _ref_flat(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return {rsharding._path_str(p): tuple(s) for p, s in flat}


def _port_flat(specs):
    """path -> [spec of each layer] (one entry outside a layer list)."""
    out = {}

    def visit(node, path):
        if isinstance(node, tsharding.PartitionSpec):
            out.setdefault('/'.join(path), []).append(tuple(node))
        elif isinstance(node, dict):
            for k, v in node.items():
                visit(v, path + (k,))
        elif isinstance(node, list):
            for v in node:
                visit(v, path)
        elif isinstance(node, tuple) and hasattr(node, '_fields'):
            for f, v in zip(node._fields, node):
                visit(v, path + (f,))
    visit(specs, ())
    return out


def _same(ref, port, stacked_keys):
    assert set(ref) == set(port), sorted(set(ref) ^ set(port))
    for path, want in ref.items():
        got = port[path]
        if path.split('/')[0] in stacked_keys:
            assert all(g == want[1:] for g in got), (path, want, got)
        else:
            assert got == [want], (path, want, got)


@pytest.fixture(scope='module')
def trees():
    """Every config's smoke param tree in both packages (shapes only)."""
    out = {}
    for arch in ARCHS:
        rcfg = rconfigs.get(arch, smoke=True)
        ref = jax.eval_shape(lambda k, c=rcfg: rmodel.init_params(k, c),
                             jax.random.key(0))
        port = tmodel.init_params(None, tconfigs.get(arch, smoke=True),
                                  device='meta')
        out[arch] = (ref, port)
    return out


@pytest.mark.parametrize('layout', ['tp', 'fsdp2d'])
@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: f'{s[0]}x{s[1]}')
@pytest.mark.parametrize('arch', ARCHS)
def test_param_and_opt_specs_equal_the_reference(trees, arch, shape, layout):
    ref_params, port_params = trees[arch]
    rspecs = rsharding.param_specs(ref_params, _ref_mesh(shape), layout)
    tspecs = tsharding.param_specs(port_params, _port_mesh(shape), layout)
    _same(_ref_flat(rspecs), _port_flat(tspecs), ('layers', 'dense_prefix'))
    ropt = rsharding.opt_specs(rspecs, radamw.OptState(0, 0, 0, 0))
    topt = tsharding.opt_specs(tspecs, tadamw.OptState(0, 0, 0, 0))
    assert tuple(ropt.step) == tuple(topt.step) == ()
    for field in ('mu', 'nu', 'ef'):
        _same(_ref_flat(getattr(ropt, field)),
              _port_flat(getattr(topt, field)), ('layers', 'dense_prefix'))
    assert tsharding.opt_specs(tspecs, tadamw.OptState(0, 0, 0, None)).ef \
        is None


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: f'{s[0]}x{s[1]}')
@pytest.mark.parametrize('arch', ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, shape):
    rcfg, tcfg = rconfigs.get(arch, smoke=True), tconfigs.get(arch,
                                                             smoke=True)
    rmesh, tm = _ref_mesh(shape), _port_mesh(shape)
    dp = rsharding.dp_axes_of(rmesh)
    assert tsharding.dp_axes_of(tm) == dp
    rb = rsharding.batch_specs(rcfg, dp)
    tb = tsharding.batch_specs(tcfg, dp)
    assert {k: tuple(v) for k, v in rb.items()} == \
        {k: tuple(v) for k, v in tb.items()}
    if tcfg.input_kind != 'tokens':
        return                  # no cache tree of a non-token frontend
    for batch in (4, 1):        # 1: the sequence-parallel caches
        ref = jax.eval_shape(lambda c=rcfg, b=batch: rmodel.init_cache_tree(
            c, b, 16))
        port = tmodel.init_cache_tree(tcfg, batch, 16, device='meta')
        rs = rsharding.cache_specs(ref, batch=batch, dp_axes=dp, mesh=rmesh)
        ts = tsharding.cache_specs(port, batch=batch, dp_axes=dp, mesh=tm)
        _same(_ref_flat(rs), _port_flat(ts), ())


@pytest.mark.parametrize('spec,shape', [
    ((('data', 'model'),), (2,)),
    ((None, ('data', 'model')), (8, 3)),
    (('data', ('data', 'model')), (4, 1)),
])
def test_sanitize_refuses_as_the_reference(spec, shape):
    rmesh, tm = _ref_mesh((2, 2)), _port_mesh((2, 2))
    with pytest.raises(ValueError) as want:
        rsharding.sanitize(JP(*spec), shape, rmesh)
    with pytest.raises(ValueError) as got:
        tsharding.sanitize(tsharding.P(*spec), shape, tm)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize('spec,shape', [
    (('data', 'model'), (6, 8)), (('model',), (3, 4)), ((None,), (5,)),
    ((('data', 'model'), None), (8, 2)), (('data',), (1, 4)),
])
def test_sanitize_keeps_what_divides(spec, shape):
    want = rsharding.sanitize(JP(*spec), shape, _ref_mesh((2, 2)))
    got = tsharding.sanitize(tsharding.P(*spec), shape, _port_mesh((2, 2)))
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize('spec', [
    ('data', 'model'), ('model', 'data'), (('data', 'model'), None),
    (None, ('data', 'model')), ('model', None, 'data')])
def test_rank_blocks_equal_the_references_shards(spec):
    """shard_tree's block of every rank equals the reference's shard on
    the device at the same mesh position, K-major and expert layouts
    kept."""
    rng = np.random.RandomState(0)
    nd = len(spec)
    shape = (8, 12, 4)[:nd] if nd == 3 else (8, 12)
    arr = rng.randn(*shape).astype(np.float32)
    rmesh = _ref_mesh((2, 2))
    placed = jax.device_put(arr, NamedSharding(rmesh, JP(*spec)))
    by_device = {s.device: np.asarray(s.data)
                 for s in placed.addressable_shards}
    t = torch.from_numpy(arr)
    layouts = [t, t.t().contiguous().t()] if nd == 2 else \
        [t, t.permute(1, 0, 2).contiguous().permute(1, 0, 2)]
    for src in layouts:
        for r, dev in enumerate(rmesh.devices.reshape(-1)):
            got = tsharding.block(src, tsharding.P(*spec),
                                  _port_mesh((2, 2), rank=r))
            np.testing.assert_array_equal(got.numpy(), by_device[dev])
            assert got.stride() == tsharding.with_layout(got, src).stride()


def test_mesh_coordinates_and_production_shapes():
    m = _port_mesh((2, 3), rank=4)
    assert m.coords == dict(data=1, model=1)
    assert m.index(('data', 'model')) == 4 and m.index('model') == 1
    assert m.axis_size(('data', 'model')) == 6
    with pytest.raises(ValueError):
        m.axes(('model', 'data'))
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert single.shape == dict(data=16, model=16) and single.rank is None
    assert multi.axis_names == ('pod', 'data', 'model')
    assert tsharding.dp_axes_of(multi) == ('pod', 'data')
    cfg = dataclasses.replace(tconfigs.get('stablelm-1.6b', smoke=True))
    tree = tmodel.init_params(None, cfg, device='meta')
    rtree = jax.eval_shape(lambda k: rmodel.init_params(
        k, rconfigs.get('stablelm-1.6b', smoke=True)), jax.random.key(0))
    rmulti = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 2, 2),
                  ('pod', 'data', 'model'))
    tm = tmesh.shape_mesh(dict(pod=1, data=2, model=2))
    _same(_ref_flat(rsharding.param_specs(rtree, rmulti, 'tp')),
          _port_flat(tsharding.param_specs(tree, tm, 'tp')),
          ('layers', 'dense_prefix'))
