"""The port's evaluation path against the JAX package's, at float64 on the
CPU: the toy efficiency, the TrackML efficiency on synthetic CSV files, the
truth-instrumented confusion counters, and the runner's refusal without a
CUDA device.

Volume 7's hit particle ids, read from its event cache and from CSV files
written from it, are held node by node against the JAX package's HostEvent.

Tolerances: report counts, efficiencies, reference-track dicts and
confusion counts are exact; purities agree to rtol 1e-12 (the same Python
arithmetic on the same integers, so in practice bit for bit)."""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig
from gnn_track_finding_tpu.data import event_cache as jax_event_cache
from gnn_track_finding_tpu.evaluation import efficiency as jax_eff
from gnn_track_finding_tpu.graph.build import build_graph_state as jax_build
from gnn_track_finding_tpu.graph.state import GraphState as JaxState
from gnn_track_finding_tpu.ops import metrics as jax_metrics

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.data import event_cache, trackml
from gnn_track_finding_tpu_torch.evaluation import efficiency
from gnn_track_finding_tpu_torch.graph.build import build_event, build_graph_state
from gnn_track_finding_tpu_torch.models import pipeline, toymc
from gnn_track_finding_tpu_torch.ops import extract, metadata, metrics

REPO = Path(__file__).resolve().parents[1]
VOL7_NPZ = REPO / ".event_cache" / "event_fafb3309e4598e9b.npz"
JCFG = JaxConfig(node_bucket=64, edge_bucket=256)
CFG = PipelineConfig(node_bucket=64, edge_bucket=256)


def _assert_reports_equal(got, ref):
    assert (got.num_reference, got.num_reconstructed) == \
        (ref.num_reference, ref.num_reconstructed)
    assert got.efficiency_pct == ref.efficiency_pct
    for name in ("track_purities", "particle_purities"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=name)


@pytest.mark.parametrize("seed,num_tracks", [(11, 16), (1, 30)])
def test_evaluate_toy_matches_jax(seed, num_tracks):
    """On the candidates of a toy run, plus a merged pair of tracks, a
    half track, an empty list and a single node."""
    ev = toymc.generate_event(seed=seed, num_tracks=num_tracks)
    g = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, CFG,
                          device="cpu")
    out = pipeline.run_pipeline(g, CFG)
    assert out.candidates
    lists = [c.nodes for c in out.candidates]
    t0, t1 = (np.flatnonzero(ev.truth == t) for t in (0, 1))
    lists += [np.concatenate([t0, t1[:2]]), t1[:3], np.array([], np.int64),
              t0[:1]]
    got = efficiency.evaluate_toy(lists, ev.truth, ev.vivl, CFG)
    ref = jax_eff.evaluate_toy(lists, ev.truth, ev.vivl, JCFG)
    assert got.num_reconstructed > 0
    _assert_reports_equal(got, ref)


def _write_csvs(directory: Path):
    """Particles and truth-mapping CSV files: particle 11 passes every cut;
    12 is below the pT cut; 13 has hits on only three layers; 14 has two
    hits in one module; 15 has hits outside the volume window too; 16 has
    no particles row.  Nodes 1-5 each hold one hit of 11 and one of 12;
    every other node holds one hit.  -> the two paths and each node's hit
    particle ids."""
    particles = [(11, 1.2, 0.3), (12, 0.3, 0.4), (13, 2.0, 1.0),
                 (14, 1.5, -1.5), (15, -3.0, 0.5), (17, 0.9, 0.5)]
    with open(directory / "particles.csv", "w") as f:
        f.write("particle_id,vx,vy,vz,px,py,pz,q,nhits\n")
        for pid, px, py in particles:
            f.write(f"{pid},0.0,0.0,0.0,{px!r},{py!r},1.0,1,5\n")
    rows = []          # (node, particle, volume, layer, module)
    for layer in range(2, 12, 2):
        rows += [(layer // 2, 11, 7, layer, 100 + layer),
                 (layer // 2, 12, 7, layer, 200 + layer)]
    for layer in (2, 4, 6):
        rows.append((10 + layer, 13, 7, layer, 300 + layer))
    for layer in (2, 4, 6, 8):
        rows.append((20 + layer, 14, 7, layer, 400 + layer))
    rows.append((29, 14, 7, 8, 408))                 # second hit, one module
    for layer in (2, 4, 6, 8, 10):
        rows.append((30 + layer, 15, 7, layer, 500 + layer))
        rows.append((40 + layer, 15, 8, layer, 600 + layer))
    for layer in (2, 4, 6, 8):
        rows.append((50 + layer, 16, 7, layer, 700 + layer))
    with open(directory / "truth.csv", "w") as f:
        f.write("node_idx,hit_id,particle_id,volume_id,layer_id,module_id,"
                "nhits\n")
        for hit, (node, pid, vol, layer, module) in enumerate(rows):
            f.write(f"{node},{1000 + hit},{pid},{vol},{layer},{module},2\n")
    n_nodes = 1 + max(r[0] for r in rows)
    hit_pids = [np.array([r[1] for r in rows if r[0] == n], np.int64)
                for n in range(n_nodes)]
    return directory / "particles.csv", directory / "truth.csv", hit_pids


def test_evaluate_matches_jax_on_synthetic_csvs(tmp_path):
    particles_csv, truth_csv, hit_pids = _write_csvs(tmp_path)
    host = SimpleNamespace(hit_particle_ids=hit_pids)
    args = (str(particles_csv), str(truth_csv))
    got_refs = efficiency.reference_tracks(*args, CFG)
    assert got_refs == jax_eff.reference_tracks(*args, JCFG)
    assert list(got_refs) == [11, 15]        # 12, 13, 14 and 16 are cut
    assert efficiency.hits_in_region(str(truth_csv), CFG) == \
        jax_eff.hits_in_region(str(truth_csv), JCFG)
    candidates = [np.array([1, 2, 3, 4, 5]),          # 11 with 12 beside it
                  np.array([1, 2]),                   # half of 11
                  np.array([32, 34, 36, 38, 40]),     # 15 in volume 7
                  np.array([12, 14, 16]),             # 13
                  np.array([22, 24, 26, 28, 29]),     # 14
                  np.array([], np.int64)]
    for window in ((7, 7), (7, 8)):
        cfg = PipelineConfig(min_volume=window[0], max_volume=window[1])
        jcfg = JaxConfig(min_volume=window[0], max_volume=window[1])
        got = efficiency.evaluate(candidates, host, *args, cfg)
        ref = jax_eff.evaluate(candidates, host, *args, jcfg)
        _assert_reports_equal(got, ref)
        assert got.num_reference == 2


@pytest.fixture(scope="module")
def vol7_hosts(tmp_path_factory):
    """Volume 7's HostEvent from the JAX package's cache reader and build,
    and the port's from its cache reader (`event_cache.hit_particle_ids`
    into `build_event`) and from the CSV files written from that cache
    (`trackml.load_event`, the C++ loader); plus the truth CSV and each
    node's truth particle."""
    xyzr, vivl, tp, pairs, extra, pre = jax_event_cache.load(
        str(VOL7_NPZ.parent), VOL7_NPZ.stem.split("_")[1])
    _, jhost = jax_build(xyzr, vivl, tp, pairs, JaxConfig(), host_extra=extra,
                         precomputed=pre, with_tracker=False)
    xyzr, vivl, tp, pairs, extra, pre = event_cache.load_npz(VOL7_NPZ)
    cfg = PipelineConfig()
    _, cache_host = build_event(
        xyzr, vivl, tp, pairs, cfg, device="cpu", mirror=pre["mirror"],
        component=pre["component"], node_ids=extra["node_ids"],
        with_tracker=False,
        hit_particle_ids=event_cache.hit_particle_ids(extra))
    paths = trackml.write_csvs(tmp_path_factory.mktemp("vol7"), xyzr, vivl,
                               pairs, extra)
    _, csv_host = trackml.load_event(paths, cfg, device="cpu",
                                     with_tracker=False)
    return jhost, {"cache": cache_host, "csv": csv_host}, paths, tp


@pytest.mark.parametrize("source", ["cache", "csv"])
def test_hit_particle_ids_match_jax_on_volume7(vol7_hosts, source):
    jhost, hosts, _, tp = vol7_hosts
    got = hosts[source].hit_particle_ids
    assert len(got) == len(jhost.hit_particle_ids) == len(tp)
    for n in range(len(tp)):
        np.testing.assert_array_equal(got[n], jhost.hit_particle_ids[n],
                                      err_msg=f"node {n}")
    assert max(len(p) for p in got) > 1          # nodes with several hits


def test_evaluate_matches_jax_on_volume7(vol7_hosts, tmp_path):
    """`evaluate` through each HostEvent on volume 7's truth CSV and a
    particles CSV with seeded momenta (about half the particles below the
    pT cut): the candidates are pairs of truth particles' nodes merged,
    halves of particles, and whole particles."""
    jhost, hosts, paths, tp = vol7_hosts
    pids = np.unique(np.concatenate(jhost.hit_particle_ids))
    rng = np.random.default_rng(7)
    particles_csv = tmp_path / "particles.csv"
    with open(particles_csv, "w") as f:
        f.write("particle_id,vx,vy,vz,px,py,pz,q,nhits\n")
        momenta = rng.normal(0.0, 1.0, (len(pids), 2)).tolist()
        for pid, (px, py) in zip(pids.tolist(), momenta):
            f.write(f"{pid},0.0,0.0,0.0,{px!r},{py!r},1.0,1,5\n")
    groups = [np.flatnonzero(tp == t) for t in np.unique(tp)]
    candidates = ([np.concatenate(groups[i:i + 2]) for i in range(0, 200, 2)]
                  + [grp[:len(grp) // 2] for grp in groups[200:400]]
                  + groups[400:])
    args = (str(particles_csv), paths.truth_csv)
    ref = jax_eff.evaluate(candidates, jhost, *args, JaxConfig())
    assert 0 < ref.num_reconstructed < ref.num_reference
    for host in hosts.values():
        _assert_reports_equal(
            efficiency.evaluate(candidates, host, *args, PipelineConfig()),
            ref)


def _to_jax(g):
    """A JAX GraphState holding a port state's values (int64 as int32)."""
    arrays = {name: jnp.asarray(a.astype(np.int32) if a.dtype == np.int64
                                else a)
              for name, a in g.to_numpy().items()}
    return JaxState(n_nodes=g.n_nodes, n_edges=g.n_edges,
                    max_degree=g.max_degree, n_layers=g.n_layers, **arrays)


def test_confusion_counts_match_jax_across_a_toy_run():
    """Every stage and extraction of a toy run, each before/after pair of
    states scored by both packages."""
    ev = toymc.generate_event(seed=11, num_tracks=16, edge_dphi_window=0.12)
    g = pipeline.prepare(build_graph_state(ev.xyzr, ev.vivl, ev.truth,
                                           ev.edge_pairs, CFG, device="cpu"),
                         CFG)
    jg = _to_jax(g)
    assert metrics.graph_summary(g) == jax_metrics.graph_summary(jg)
    decisions = 0
    for i in (1, 2, 3):
        staged = pipeline.stage_step(g, CFG, i)
        nxt = extract.apply_extraction(
            staged, extract.extract_candidates(staged, CFG), CFG)
        if i % 2 == 0:
            nxt = metadata.remove_state_metadata(nxt, CFG)
        jstaged, jnext = _to_jax(staged), _to_jax(nxt)
        for (b, a), (jb, ja) in (((g, staged), (jg, jstaged)),
                                 ((staged, nxt), (jstaged, jnext))):
            got = metrics.edge_decision_confusion(b, a)
            ref = jax_metrics.edge_decision_confusion(jb, ja)
            assert vars(got) == vars(ref), i
            assert got.rates() == ref.rates()
            assert metrics.graph_summary(a) == jax_metrics.graph_summary(ja)
            decisions += got.tp + got.fp
        g, jg = nxt, jnext
    assert decisions > 0
    mask = g.edge_mask & (g.truth[g.src] >= 0)
    chi2 = torch.arange(g.num_padded_edges, dtype=torch.float64)
    same, vals = metrics.chi2_truth_dump(g, chi2, mask)
    jsame, jvals = jax_metrics.chi2_truth_dump(jg, jnp.asarray(chi2.numpy()),
                                               jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(same, jsame)
    np.testing.assert_array_equal(vals, jvals)


@pytest.mark.parametrize("args", [["--toy"], ["--event", str(VOL7_NPZ),
                                               "--calibrate"]],
                         ids=["toy", "calibrate"])
def test_run_cli_new_paths_require_cuda(args):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "gnn_track_finding_tpu_torch.run", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
