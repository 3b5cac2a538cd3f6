"""Import hygiene and device discipline of the PyTorch port: it imports
neither JAX nor the JAX package, builds nothing at import, and never runs on
the CPU unless asked to."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / 'src' / 'repro_torch'


def _port_modules():
    return sorted('.'.join(p.relative_to(ROOT / 'src').with_suffix('').parts)
                  .replace('.__init__', '') for p in PORT.rglob('*.py'))


def test_importing_every_module_leaves_jax_and_repro_out():
    mods = _port_modules()
    assert 'repro_torch.launch.serve' in mods and len(mods) >= 20
    # the port's own copies of the reference's jax-free modules
    assert {'repro_torch.runtime.faults', 'repro_torch.runtime.telemetry',
            'repro_torch.core.hwmodel', 'repro_torch.core.analog',
            'repro_torch.core.bitplane'} <= set(mods)
    # tensor-parallel serving: the process group, layout and collectives
    assert {'repro_torch.distributed.ranks',
            'repro_torch.distributed.sharding',
            'repro_torch.distributed.collectives'} <= set(mods)
    # sharded training: the rank mesh
    assert 'repro_torch.launch.mesh' in mods
    code = ('import importlib, sys\n'
            f'for m in {mods!r}: importlib.import_module(m)\n'
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            'print(bad)\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={'PYTHONPATH': str(ROOT / 'src'),
                              'PATH': '/usr/bin:/bin'})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


@pytest.mark.parametrize('path', sorted(str(p.relative_to(ROOT)) for p in
                                        list(PORT.rglob('*.py'))
                                        + [ROOT / 'chip_smoke.py']))
def test_source_imports_nothing_of_jax_or_repro(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [n for n in names if n.split('.')[0] in ('jax', 'jaxlib', 'repro')]
    assert not bad, bad


def test_kernel_sources_present_for_every_library():
    from repro_torch.kernels import build
    for name in build.SOURCES:
        src = (build.CSRC / f'{name}.cu').read_text()
        assert 'Replaces' in src and 'Bound on the H100' in src, name
    assert not build.BUILD_LOGS       # nothing was compiled by importing


def test_entry_points_refuse_a_missing_card():
    """Without ``device='cpu'`` an entry point runs on the card or raises;
    it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is visible: the default device is real')
    from repro_torch import device
    from repro_torch.configs import get
    from repro_torch.launch import serve
    from repro_torch.models import attention, model
    cfg = get('stablelm-1.6b', smoke=True)
    sizes = dict(num_pages=5, page_size=4, max_blocks=2)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        device.resolve()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        serve.serve_continuous('stablelm-1.6b', n_requests=1, quiet=True)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        serve.main(['--continuous'])
    # tensor parallelism places its ranks on the card too, and spawns none
    with pytest.raises(RuntimeError, match='no CUDA device'):
        serve.serve_continuous('stablelm-1.6b', tp=2, n_requests=1,
                               quiet=True)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        serve.main(['--continuous', '--tp', '2'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        serve.serve('stablelm-1.6b', quiet=True)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        serve.main([])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        model.init_cache_tree(cfg, 2, 8)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        attention.init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        model.init_paged_cache_tree(cfg, 2, **sizes)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        attention.init_paged_cache(cfg, 2, **sizes)
    assert device.resolve('cpu') == torch.device('cpu')
    tree = model.init_paged_cache_tree(cfg, 2, device='cpu', **sizes)
    one = attention.init_paged_cache(cfg, 2, device='cpu', **sizes)
    assert all(t.device.type == 'cpu' for t in
               list(tree['layers'].values()) + list(one.values()))


def test_mla_entry_points_refuse_a_missing_card():
    """The same discipline on deepseek-v3's dense prefix (MLA latent
    caches, the int8 latent tier) and for the parameter init."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is visible: the default device is real')
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.models import attention, model
    cfg = dataclasses.replace(get('deepseek-v3-671b', smoke=True), moe=None)
    sizes = dict(num_pages=5, page_size=4, max_blocks=2)
    for kv_dtype in (None, 'int8'):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            model.init_paged_cache_tree(cfg, 2, kv_dtype=kv_dtype, **sizes)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            attention.init_paged_cache(cfg, 2, kv_dtype=kv_dtype, **sizes)
        tree = model.init_paged_cache_tree(cfg, 2, kv_dtype=kv_dtype,
                                           device='cpu', **sizes)
        one = attention.init_paged_cache(cfg, 2, kv_dtype=kv_dtype,
                                         device='cpu', **sizes)
        assert 'cl' in tree['layers'] and 'cl' in one
        assert all(t.device.type == 'cpu' for t in
                   list(tree['layers'].values()) + list(one.values()))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        model.init_params(torch.Generator(), cfg)
    params = model.init_params(torch.Generator(), cfg, device='cpu')
    assert params['layers'][0]['attn']['w_ukv'].device.type == 'cpu'


def test_synthetic_data_is_seeded_and_affine():
    from repro_torch.configs import get
    from repro_torch.data import synthetic
    dc = synthetic.for_arch(get('stablelm-1.6b', smoke=True), global_batch=4,
                            seq_len=32)
    a = synthetic.make_batch(dc, 0)
    b = synthetic.make_batch(dc, 0)
    assert torch.equal(a['inputs'], b['inputs'])
    assert not torch.equal(a['inputs'], synthetic.make_batch(dc, 1)['inputs'])
    assert a['inputs'].shape == (4, 32) and a['inputs'].dtype == torch.int32
    np.testing.assert_array_equal(a['inputs'][:, 1:].numpy(),
                                  a['labels'][:, :-1].numpy())
    assert int(a['inputs'].max()) < 256 and int(a['inputs'].min()) >= 0
