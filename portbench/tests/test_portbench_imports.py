"""What a run may load and where it may run: no JAX and no JAX package in
the process, no program code in the reference, no result without a card or
without the port."""
import ast
import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests.cells import CELLS

ROOT = harness.HERE.parent


@pytest.mark.parametrize('names, found', [
    (['jax', 'jax.numpy', 'neurodiffeq_tpu_torch.fields'], ['jax']),
    (['jaxlib.xla_client', 'flax.linen', 'neurodiffeq_tpu.solvers', 'neurodiffeq_tpu'], ['flax', 'jaxlib', 'neurodiffeq_tpu']),
    (['neurodiffeq_tpu_torch', 'neurodiffeq_tpu_torch.ops.taylor_mlp', 'jaxtyping', 'portbench.harness'], []),
])
def test_forbidden_names_are_compared_whole(names, found):
    assert harness.forbidden_modules(names) == found


def imported(path):
    """Every module ``path`` imports, by its full name."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ('portbench.' if node.level else '') + (node.module or '')


def imported_tops(path):
    return {name.split('.')[0] for name in imported(path)}


@pytest.mark.parametrize('path', sorted(harness.HERE.rglob('*.py')), ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_file_of_the_benchmark_imports_jax(path):
    assert not set(imported_tops(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize('path', sorted((harness.HERE / 'reference').glob('*.py')), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = set(imported(path))
    assert {name.split('.')[0] for name in names} <= {'math', 'contextlib', 'torch', 'portbench'}
    assert all(name.startswith('portbench.reference') for name in names if name.startswith('portbench'))


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); from portbench import harness; "
            "import neurodiffeq_tpu_torch, neurodiffeq_tpu_torch.solvers, neurodiffeq_tpu_torch.ops.taylor_mlp; "
            "cell = harness.Cell.load(%r); print(harness.forbidden_modules())" % (str(ROOT), CELLS[0]))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_without_a_card_the_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip('this machine has a CUDA card')
    out = subprocess.run([sys.executable, 'portbench/run.py', '--workload', CELLS[0], '--seed',
                          str(2 ** 31 + 5), '--seconds', '1', '--trace', '0'], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ''
    assert 'CUDA' in out.stderr


def test_without_the_port_the_run_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(harness.HERE, tmp_path / 'portbench', ignore=shutil.ignore_patterns('__pycache__'))
    paths = json.loads((ROOT / 'BENCHMARK.json').read_text())['paths']
    assert paths == ['portbench']
    out = subprocess.run([sys.executable, 'portbench/run.py', '--workload', CELLS[0], '--seed', '7',
                          '--seconds', '1', '--trace', '0'], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ''
