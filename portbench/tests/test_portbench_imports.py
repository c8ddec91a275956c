"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the port; top-level module names are compared
whole (the port's name begins with the JAX package's)."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

from portbench import spec

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'pixelrec_multimodal_tpu'}
PORT = 'pixelrec_multimodal_tpu_torch'
SOURCES = sorted(p for p in spec.HERE.rglob('*.py')
                 if 'tests' not in p.relative_to(spec.HERE).parts)


def top_level_imports(path: Path) -> set:
    """Top-level names of every absolute import in ``path``."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split('.')[0])
    return out


@pytest.mark.parametrize('path', SOURCES,
                         ids=[str(p.relative_to(spec.HERE)) for p in SOURCES])
def test_no_jax_and_the_reference_apart_from_the_port(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, path
    if 'reference' in path.relative_to(spec.HERE).parts:
        assert PORT not in names, path


def test_the_check_compares_whole_names(tmp_path):
    src = tmp_path / 'probe.py'
    src.write_text('import pixelrec_multimodal_tpu_torch.models\n'
                   'from pixelrec_multimodal_tpu.ops import x\n')
    assert top_level_imports(src) == {PORT, 'pixelrec_multimodal_tpu'}
    assert not {PORT} & FORBIDDEN


def test_a_run_leaves_no_jax_module_loaded():
    """A whole run at a tiny size on the CPU, the check and the reference
    included, loads no module of JAX or the JAX package."""
    import subprocess
    import sys
    code = ('import sys; sys.path.insert(0, %r)\n'
            'from portbench import run\n'
            'from portbench.tests.test_portbench_faults import tiny\n'
            'for name in ("concat.topk-seen.u512", "concat.train.b262144"):\n'
            '    result, _ = run.run(tiny(name), 2147483737, 0.2, False,'
            ' "cpu")\n'
            '    assert result["correct"], result\n'
            'print(run.forbidden_modules())\n' % str(spec.ROOT))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_a_module_of_jax_loaded_by_the_check_withholds_the_result(
        monkeypatch):
    import sys
    import types

    from portbench import run
    from portbench.generators import topk
    from portbench.tests.test_portbench_faults import tiny
    readings = topk.Traffic.readings

    def loads_jax(self):
        out = readings(self)
        monkeypatch.setitem(sys.modules, 'jax', types.ModuleType('jax'))
        return out
    monkeypatch.setattr(topk.Traffic, 'readings', loads_jax)
    with pytest.raises(run.ForbiddenModules):
        run.run(tiny('concat.topk-seen.u512'), 2147483741, 0.2, False, 'cpu')
