"""The kernel build's content hash: ``ops/_build.library_path`` names a
library by its source, the shared headers and the compiler flags, so an
edited header builds anew instead of loading a stale library. Runs on the
CPU: it hashes files and compiles nothing."""
from pixelrec_multimodal_tpu_torch.ops import _build


def test_library_path_follows_sources_and_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    (tmp_path / 'k.cu').write_text('#include "shared.cuh"\n')
    (tmp_path / 'shared.cuh').write_text('// chain v1\n')
    first = _build.library_path('k')
    assert first.name.startswith('k-') and first.suffix == '.so'
    assert _build.library_path('k') == first  # stable while nothing changes
    (tmp_path / 'shared.cuh').write_text('// chain v2\n')
    second = _build.library_path('k')
    assert second != first
    (tmp_path / 'k.cu').write_text('#include "shared.cuh"\n// edited\n')
    assert _build.library_path('k') not in (first, second)


def test_every_source_is_a_kernel_with_the_shared_header():
    """Every kernel includes the shared chain: the attention kernels
    through their own shared header, the pair kernels through the int8
    chain's header (their int8 modes)."""
    sources = _build.all_sources()
    assert sources == ['attention_gram_mlp', 'attention_mlp',
                       'attention_screen_mlp', 'gated_factored_mlp',
                       'gated_pairwise_mlp', 'pairwise_mlp']
    for shared in ('attention_common.cuh', 'mlp_chain_int8.cuh'):
        assert '#include "mlp_chain.cuh"' in (
            _build.CSRC / shared).read_text()
    for name in sources:
        header = ('attention_common.cuh' if name.startswith('attention')
                  else 'mlp_chain_int8.cuh')
        assert f'#include "{header}"' in (
            _build.CSRC / f'{name}.cu').read_text()


def test_probes_build_beside_the_kernels(tmp_path, monkeypatch):
    """The probes P1-P3 live in ``probes/csrc``, apart from the scorer
    kernels, and build with the kernels' headers: an edited header of
    ``ops/csrc`` names a probe's library anew too."""
    assert _build.probe_sources() == ['int8_mxu', 'vpu_roofline']
    assert not set(_build.probe_sources()) & set(_build.all_sources())
    ops, probes = tmp_path / 'ops', tmp_path / 'probes'
    ops.mkdir()
    probes.mkdir()
    monkeypatch.setattr(_build, 'CSRC', ops)
    monkeypatch.setattr(_build, 'PROBES_CSRC', probes)
    (ops / 'shared.cuh').write_text('// chain v1\n')
    (probes / 'p.cu').write_text('#include "shared.cuh"\n')
    first = _build.library_path('p')
    (ops / 'shared.cuh').write_text('// chain v2\n')
    assert _build.library_path('p') != first
