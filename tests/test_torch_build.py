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


def test_nvjpeg_binding_links_its_library_into_its_name(monkeypatch):
    """The nvJPEG binding (``data/csrc/jpeg_decode.cu``), registered by
    the image tier, lives apart from the kernels, links the toolkit's
    libnvjpeg from the directory it was found in, and that link line is in
    its library's name; the kernels link nothing."""
    from pixelrec_multimodal_tpu_torch.data import image_codecs
    assert image_codecs.JPEG_SOURCE == 'jpeg_decode'
    assert _build._source_dir('jpeg_decode') == \
        _build.Path(image_codecs.__file__).resolve().parent / 'csrc'
    assert 'jpeg_decode' not in _build.all_sources()
    assert all(_build.link_flags(n) == () for n in _build.all_sources())
    names = []
    for d in ('/cuda-a/lib64', '/cuda-b/lib64'):
        monkeypatch.setattr(_build, 'toolkit_library',
                            lambda stem, d=d: _build.Path(d) / f'lib{stem}.so')
        flags = _build.link_flags('jpeg_decode')
        assert flags[:2] == ('-L', d) and f'-rpath={d}' in flags
        names.append(_build.library_path('jpeg_decode'))
    assert names[0] != names[1]
    monkeypatch.setattr(_build, 'toolkit_library', lambda stem: None)
    assert _build.link_flags('jpeg_decode') == ('-lnvjpeg',)
