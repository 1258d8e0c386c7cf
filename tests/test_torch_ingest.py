"""The port's CSV ingest (C++ loader), event cache writer and prefetcher.

The volume-7 event cache is written out as the three TrackML CSV files
(formats of gnn_track_finding_tpu/data/trackml.py:6-13 and
native/loader.cc), with a few hits of another volume appended that the
volume window must drop.  Reading them back through the port's loader must
give the cache's arrays: ids, layers, pairs, components and truth exact,
coordinates to rtol 1e-15 (r is recomputed from x and y); the JAX
package's pandas reader must agree on the same files."""

from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig
from gnn_track_finding_tpu.data import event_cache as jax_event_cache
from gnn_track_finding_tpu.data import trackml as jax_trackml

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.data import (event_cache, native_loader,
                                              prefetch, trackml)
from gnn_track_finding_tpu_torch.data.event_cache import load_npz
from gnn_track_finding_tpu_torch.graph import state as tstate
from gnn_track_finding_tpu_torch.graph.build import build_graph_state

VOL7_NPZ = (Path(__file__).resolve().parents[1] / ".event_cache"
            / "event_fafb3309e4598e9b.npz")
N_OTHER = 5          # hits of volume 12, outside the window


def _write_csvs(d: Path, arrays) -> trackml.TrackMLPaths:
    """The event's CSVs (trackml.write_csvs) plus N_OTHER hits of volume
    12, wired to volume-7 hits, that the volume window must drop."""
    xyzr, vivl, tp, pairs, extra, _ = arrays
    paths = trackml.write_csvs(d, xyzr, vivl, pairs, extra)
    ids = extra["node_ids"]
    other = (ids.max() + 1 + np.arange(N_OTHER)).tolist()
    with open(paths.nodes_csv, "a") as f:
        f.writelines(f"{o},12002,{1.5 + j!r},-2.25,300.125\n"
                     for j, o in enumerate(other))
    with open(paths.edges_csv, "a") as f:
        f.writelines(f"{o},{ids[j]},0.25\n" for j, o in enumerate(other))
    with open(paths.truth_csv, "a") as f:
        f.writelines(f"{o},{9000000 + o},77,12,2,5,1\n" for o in other)
    return paths


@pytest.fixture(scope="module")
def event(tmp_path_factory):
    arrays = load_npz(VOL7_NPZ)
    return arrays, _write_csvs(tmp_path_factory.mktemp("csv"), arrays)


def _native(paths):
    return native_loader.load_event_arrays_native(
        paths.nodes_csv, paths.edges_csv, paths.truth_csv, 7, 7)


def test_csv_ingest_matches_the_cache(event):
    (xyzr, vivl, tp, pairs, extra, pre), paths = event
    nx, nv, nt, npairs, nex = _native(paths)
    np.testing.assert_allclose(nx, xyzr, rtol=1e-15, atol=0)
    np.testing.assert_array_equal(nv, vivl)
    np.testing.assert_array_equal(nt, tp)
    np.testing.assert_array_equal(npairs, pairs)
    np.testing.assert_array_equal(nex["node_ids"], extra["node_ids"])
    np.testing.assert_array_equal(nex["components"], pre["component"])
    for k in event_cache.TRUTH_KEYS:
        np.testing.assert_array_equal(nex[k], extra[k], err_msg=k)


def test_csv_ingest_matches_jax_pandas_reader(event):
    _, paths = event
    nx, nv, nt, npairs, nex = _native(paths)
    jpaths = jax_trackml.TrackMLPaths(paths.nodes_csv, paths.edges_csv,
                                      paths.truth_csv)
    px, pv, pt, pp, pex = jax_trackml.load_event_arrays(jpaths, JaxConfig())
    np.testing.assert_allclose(nx, px, rtol=1e-15, atol=0)
    np.testing.assert_array_equal(nv, pv)
    np.testing.assert_array_equal(nt, pt)
    np.testing.assert_array_equal(npairs, pp)
    np.testing.assert_array_equal(nex["node_ids"], pex["node_ids"])
    off, moff = nex["hit_off"], nex["mod_off"]
    for i in range(len(nt)):
        np.testing.assert_array_equal(nex["hit_flat"][off[i]:off[i + 1]],
                                      pex["hit_ids"][i])
        np.testing.assert_array_equal(nex["pid_flat"][off[i]:off[i + 1]],
                                      pex["hit_particle_ids"][i])
        np.testing.assert_array_equal(nex["mod_flat"][moff[i]:moff[i + 1]],
                                      pex["module_ids"][i])


def test_load_event_builds_the_cached_state_and_writes_the_cache(
        event, tmp_path):
    (xyzr, vivl, tp, pairs, extra, pre), paths = event
    cfg = PipelineConfig()
    want = build_graph_state(xyzr, vivl, tp, pairs, cfg, device="cpu",
                             mirror=pre["mirror"], component=pre["component"])
    key = event_cache.cache_key(paths.nodes_csv, paths.edges_csv,
                                paths.truth_csv, 7, 7)
    for hit in (False, True):
        g, host = trackml.load_event(paths, cfg, device="cpu",
                                     cache_dir=tmp_path)
        assert Path(event_cache.cache_path(tmp_path, key)).exists()
        np.testing.assert_array_equal(host.mirror, pre["mirror"])
        assert host.tracker is not None
        got, ref = g.to_numpy(), want.to_numpy()
        for name in tstate.tensor_fields():
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-15,
                                       atol=0, err_msg=f"{name} (hit {hit})")
    g, host = trackml.load_event(paths, cfg, device="cpu", cache_dir=tmp_path,
                                 with_tracker=False)
    assert host.tracker is None and g.n_edges == want.n_edges


def test_saved_cache_is_read_by_jax(event, tmp_path):
    (xyzr, vivl, tp, pairs, extra, pre), _ = event
    event_cache.save(tmp_path, "k", xyzr, vivl, tp, pairs, extra,
                     pre["mirror"], pre["component"])
    ref = jax_event_cache.load(str(VOL7_NPZ.parent), "fafb3309e4598e9b")
    got = jax_event_cache.load(str(tmp_path), "k")
    for a, b in zip(got[:4], ref[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for k in ("node_ids", "components"):
        np.testing.assert_array_equal(got[4][k], ref[4][k])
    for k in ("hit_ids", "hit_particle_ids", "module_ids"):
        assert len(got[4][k]) == len(ref[4][k])
        for i in (0, 17, len(ref[4][k]) - 1):
            np.testing.assert_array_equal(got[4][k][i], ref[4][k][i])
    for k in ("mirror", "component"):
        assert got[5][k].dtype == ref[5][k].dtype
        np.testing.assert_array_equal(got[5][k], ref[5][k])


def test_prefetch_yields_serial_ingest_in_order(event, tmp_path):
    _, paths = event
    cfg = PipelineConfig()
    serial = trackml.load_event(paths, cfg, device="cpu",
                                with_tracker=False)[0]
    got = list(prefetch.prefetch_trackml([paths] * 3, cfg, device="cpu",
                                         depth=2, workers=2))
    assert len(got) == 3
    for g in got:
        for name in tstate.tensor_fields():
            assert torch.equal(getattr(g, name), getattr(serial, name)), name


def test_prefetch_reraises_at_the_failing_position():
    def boom():
        raise KeyError("event 2")

    factories = [lambda: 0, lambda: 1, boom, lambda: 3]
    it = prefetch.prefetch(factories, depth=2, workers=2)
    assert next(it) == 0 and next(it) == 1
    with pytest.raises(KeyError, match="event 2"):
        next(it)
    with pytest.raises(ValueError):
        next(prefetch.prefetch([], depth=0))
