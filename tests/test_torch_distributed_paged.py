"""KV-sequence-sharded distributed decode of the port in the paged layout
(page size 8, 26 pages: a rank owns 13), against the reference's and
its own undistributed engine: ``test_torch_distributed.py``'s stream
cases over their own two gloo ranks and reference subprocess (one start
each per module), paper-edge smoke at float32, f32, posit16 and posit8
KV: streams token-identical on both ranks, to the reference's
``ServingEngine`` and its distributed engine, each rank's KV bytes half
the undistributed engine's, and every slot writing rows on rank 1 (its
pool pages 13-25)."""
import pytest

pytest.importorskip("torch")

from test_torch_distributed import (FORMATS, check_live_rows,  # noqa: E402,F401
                                    check_streams, dense_runs)
from _torch_threads import torch_threads  # noqa: E402,F401


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return dense_runs(tmp_path_factory.mktemp("distributed_paged"), "paged")


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("layout", ["paged"])
def test_two_rank_streams_equal_reference(runs, layout, fmt):
    check_streams(runs, layout, fmt)


def test_live_rows_on_both_shards(runs):
    check_live_rows(runs, "paged")
