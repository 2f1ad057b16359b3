"""Dead rows are never read: torus(2,4,2), float32.

The check and the other topologies are in test_torch_transport_tables.py;
this part of the sweep is a file of its own so that another test worker
takes its interpret-mode compiles.
"""
import pytest

pytest.importorskip("torch")

from test_torch_transport_tables import (_fresh_caches,  # noqa: F401
                                         check_dead_rows_never_read,
                                         dead_row_cases)


@pytest.mark.parametrize("topo_name,coll,algo,dtype",
                         dead_row_cases(["3lvl16"], ("float32",)))
def test_dead_rows_never_read(topo_name, coll, algo, dtype):
    check_dead_rows_never_read(topo_name, coll, algo, dtype)
