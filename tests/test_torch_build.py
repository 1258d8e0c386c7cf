"""Port ingest vs the JAX package: config, GraphState fields, the
numpy round trip, and the port's freedom from JAX.

Both packages build the same event from the same numpy arrays (toy events
from models/toymc.py, and the committed volume-7 event cache); every
GraphState field must agree exactly (values; the port's integer fields
are int64 where the JAX package's are int32)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_track_finding_tpu.config import PipelineConfig as JaxConfig
from gnn_track_finding_tpu.data import event_cache as jax_event_cache
from gnn_track_finding_tpu.graph.build import build_graph_state as jax_build
from gnn_track_finding_tpu.models import toymc

from gnn_track_finding_tpu_torch.config import PipelineConfig
from gnn_track_finding_tpu_torch.data.event_cache import load_npz
from gnn_track_finding_tpu_torch.graph import state as tstate
from gnn_track_finding_tpu_torch.graph.build import build_graph_state

REPO = Path(__file__).resolve().parents[1]
VOL7_NPZ = REPO / ".event_cache" / "event_fafb3309e4598e9b.npz"
TOY_CFG = dict(node_bucket=64, edge_bucket=256)


def _assert_states_equal(jg, g):
    for name in ("n_nodes", "n_edges", "max_degree", "n_layers"):
        assert getattr(g, name) == getattr(jg, name), name
    port = g.to_numpy()
    for name in tstate.tensor_fields():
        ref = np.asarray(getattr(jg, name))
        got = port[name]
        assert got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


def _toy(seed):
    ev = toymc.generate_event(seed=seed, num_tracks=16, edge_dphi_window=0.12)
    jg, host = jax_build(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                         JaxConfig(**TOY_CFG))
    g = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                          PipelineConfig(**TOY_CFG), device="cpu",
                          mirror=host.mirror)
    return jg, g


def _volume7():
    xyzr, vivl, tp, pairs, extra, pre = load_npz(VOL7_NPZ)
    cfg = JaxConfig()
    jg, _ = jax_build(xyzr, vivl, tp, pairs, cfg, host_extra=extra,
                      precomputed=pre, with_tracker=False)
    g = build_graph_state(xyzr, vivl, tp, pairs, PipelineConfig(),
                          device="cpu", mirror=pre["mirror"],
                          component=pre["component"])
    return jg, g


def test_config_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(PipelineConfig)]
    assert tf == jf
    cfg, jcfg = PipelineConfig(), JaxConfig()
    assert cfg.ms_coefficient() == jcfg.ms_coefficient()
    for upd in (False, True):
        assert cfg.cluster_thresholds(upd) == jcfg.cluster_thresholds(upd)


@pytest.mark.parametrize("source", ["toy7", "toy11", "volume7_npz"])
def test_graph_state_matches_jax(source):
    jg, g = _volume7() if source == "volume7_npz" else _toy(int(source[3:]))
    _assert_states_equal(jg, g)


def test_load_npz_matches_jax_event_cache_load(tmp_path):
    key = "fafb3309e4598e9b"
    jax_out = jax_event_cache.load(str(VOL7_NPZ.parent), key)
    out = load_npz(VOL7_NPZ)
    for a, b in zip(out[:4], jax_out[:4]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out[4]["node_ids"], jax_out[4]["node_ids"])
    for k in ("mirror", "component"):
        np.testing.assert_array_equal(out[5][k], jax_out[5][k])


def test_clean_mode_mirror_is_identity_and_component_is_computed():
    ev = toymc.generate_event(seed=3, num_tracks=10, edge_dphi_window=0.12)
    jcfg = JaxConfig(bug_compat=False, **TOY_CFG)
    jg, _ = jax_build(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs, jcfg,
                      with_tracker=False)
    g = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                          PipelineConfig(bug_compat=False, **TOY_CFG),
                          device="cpu")
    _assert_states_equal(jg, g)
    # bug_compat without a given mirror computes the set()-order one, as
    # the JAX ingest does
    jg, _ = jax_build(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                      JaxConfig(**TOY_CFG))
    g = build_graph_state(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                          PipelineConfig(**TOY_CFG), device="cpu")
    _assert_states_equal(jg, g)
    assert not np.array_equal(g.mirror.numpy(),
                              np.arange(g.num_padded_edges))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_from_numpy_to_numpy_round_trip(dtype):
    ev = toymc.generate_event(seed=11, num_tracks=16, edge_dphi_window=0.12)
    jg, _ = jax_build(ev.xyzr, ev.vivl, ev.truth, ev.edge_pairs,
                      JaxConfig(**TOY_CFG))
    arrays = {name: np.asarray(getattr(jg, name))
              for name in tstate.tensor_fields()}
    g = tstate.from_numpy(arrays, n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                          max_degree=jg.max_degree, n_layers=jg.n_layers,
                          device="cpu", dtype=dtype)
    back = g.to_numpy()
    for name, ref in arrays.items():
        got = back[name]
        if np.issubdtype(ref.dtype, np.floating):
            assert got.dtype == np.dtype(str(dtype).split(".")[1])
            np.testing.assert_array_equal(got, ref.astype(got.dtype),
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)
    assert g.replace(n_nodes=0).n_nodes == 0 and g.n_nodes == jg.n_nodes


_IMPORTS = {
    # every module of the package
    "package": ("import pkgutil, importlib\n"
                "import gnn_track_finding_tpu_torch as p\n"
                "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
                "    importlib.import_module(m.name)\n"),
    # the digest tool the card runs (chip_smoke phase 7)
    "validate_port_tool": "import tools.validate_port_vs_reference\n",
    # the multi-device path and the rank workers a spawned process imports
    "parallel": ("import gnn_track_finding_tpu_torch.ops.collect\n"
                 "import gnn_track_finding_tpu_torch.parallel.edge_shard\n"
                 "import gnn_track_finding_tpu_torch.parallel.mesh\n"
                 "import gnn_track_finding_tpu_torch.parallel.multihost\n"
                 "import gnn_track_finding_tpu_torch.testing\n"),
}


@pytest.mark.parametrize("case", sorted(_IMPORTS))
def test_port_imports_no_jax(case):
    code = (
        "import sys\n" + _IMPORTS[case] +
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'pandas', 'networkx', 'sklearn', 'matplotlib',\n"
        "        'orbax', 'gnn_track_finding_tpu')\n"
        "       or m == 'tools.validate_vs_reference']\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
