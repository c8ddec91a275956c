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
