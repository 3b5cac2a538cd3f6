"""The rest of ``core/hwmodel.py`` against the reference: the core's
latency and area, the ADC-overhead cut, the Fig. 8 breakdown, the SOTA
table and comparison, ``map_matmul``, and ``map_architecture`` over every
registered config (published and smoke widths), each returning the
reference's floats exactly."""

import pytest

from repro import configs as rconfigs
from repro.core import hwmodel as rhw
from repro_torch import configs as tconfigs
from repro_torch.core import hwmodel as thw

CORES = {'default': {}, 'wide': dict(macros_v=4, macros_h=16, cb_bits=4)}


def _cores(name):
    return (rhw.CoreConfig(**CORES[name]), thw.CoreConfig(**CORES[name]))


@pytest.mark.parametrize('core', sorted(CORES))
def test_core_figures_equal_reference(core):
    rc, tc = _cores(core)
    assert thw.core_vmm_latency(tc) == rhw.core_vmm_latency(rc)
    assert thw.core_area_um2(tc) == rhw.core_area_um2(rc)
    assert thw.adc_overhead_reduction(tc) == rhw.adc_overhead_reduction(rc)
    for activity in (0.5, 0.25):
        assert thw.overhead_breakdown(tc, activity) == \
            rhw.overhead_breakdown(rc, activity)
    assert thw.sota_comparison(tc) == rhw.sota_comparison(rc)


def test_paper_headlines():
    assert thw.core_vmm_latency()['total'] < 20e-9
    assert thw.adc_overhead_reduction() == 0.875
    assert abs(sum(thw.overhead_breakdown().values()) - 1.0) < 1e-12
    assert thw.SOTA_BASELINES == rhw.SOTA_BASELINES
    assert len(thw.sota_comparison()) == 8
    assert tconfigs.names() == rconfigs.names()


@pytest.mark.parametrize('mkn', [(1, 1024, 256), (1, 2048, 5632),
                                 (7, 100, 3), (128, 7168, 129280)])
@pytest.mark.parametrize('cores', [1, 3])
def test_map_matmul_equals_reference(mkn, cores):
    for activity in (0.5, 0.8):
        assert thw.map_matmul(*mkn, n_cores=cores, activity=activity) == \
            rhw.map_matmul(*mkn, n_cores=cores, activity=activity)


@pytest.mark.parametrize('smoke', [False, True], ids=['full', 'smoke'])
@pytest.mark.parametrize('arch', tconfigs.names())
def test_map_architecture_equals_reference(arch, smoke):
    rcfg = rconfigs.get(arch, smoke=smoke)
    tcfg = tconfigs.get(arch, smoke=smoke)
    assert tcfg.per_token_matmuls() == rcfg.per_token_matmuls()
    for kw in ({}, dict(activity=0.3, target_tokens_per_s=1e3)):
        assert thw.map_architecture(tcfg, **kw) == \
            rhw.map_architecture(rcfg, **kw)
