"""A whole run, past the harness's look for a card, at a thousand points on
the CPU (enough for a squeezed batch to read past ``batch_law``'s limit):
sound, it is correct against the committed limits; with the timed path
broken underneath, ``correct`` comes out false, for each fault
that the cell can have (one chip: no exchange between chips to leave out)."""
import pytest

from portbench import faults, harness
from portbench.tests.cells import CELLS, load, small

SEED = 2 ** 31 + 99


def run(name, fault=None):
    cell = small(name, points=1024)
    if fault is None:
        return harness.run(name, SEED, 0.3, False, device='cpu', cell=cell)
    with faults.planted(fault, cell.traffic['kind']):
        return harness.run(name, SEED, 0.3, False, device='cpu', cell=cell)


@pytest.mark.parametrize('name', CELLS)
def test_a_sound_run_is_correct(name):
    result = run(name)
    assert result['correct'] is True, result['checks']
    assert list(result)[-1] == 'checks' and all(c['limit'] is not None for c in result['checks'].values())


@pytest.mark.parametrize('name, fault', [(n, f) for n in CELLS for f in faults.applicable(load(n))])
def test_a_fault_underneath_makes_the_run_incorrect(name, fault):
    result = run(name, fault)
    assert result['correct'] is False
    assert any(c['value'] > c['limit'] for c in result['checks'].values())
