"""The port's module list against the JAX package's, read with ast.

Every public top-level def or class of each module of
gnn_track_finding_tpu/ must be bound in the port's module at the same
path (as a def, a class, an assignment or an imported name), or stand in
NOT_PORTED with its reason; every JAX file that calls pallas_call must
have its kernel's port files in KERNELS.  A NOT_PORTED entry that the
port now binds, or that names nothing JAX defines, fails, so the list
cannot go stale.  Neither package is imported: the cases take well under
a second and need no JAX."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "gnn_track_finding_tpu"
PORT = ROOT / "gnn_track_finding_tpu_torch"

# "module" (a whole module) or "module::name" -> why the port lacks it
NOT_PORTED = {
    "ops/gtools.py": "TPU gather workarounds; torch indexing does their "
                     "job",
    "utils/platform.py": "probes JAX backends only; every port entry "
                         "point takes a device",
    "data/event_cache.py::LazyRagged": "JAX-only plumbing for ragged "
                                       "host arrays",
    "data/native_loader.py::available": "feeds only JAX's silent fallback "
                                        "to device CCA; the port raises "
                                        "when the loader fails to build",
    "data/trackml.py::load_event_arrays": "the pandas CSV reader; the "
                                          "port reads CSVs through the "
                                          "C++ loader",
    "graph/build.py::UnionFind": "the port computes the same labels with "
                                 "scipy (graph/build.py)",
    "graph/cca.py::connected_components": "dead CCA variant; the schedule "
                                          "runs connected_components_fixed",
    "graph/cca.py::connected_components_paired": "dead CCA variant",
    "graph/cca.py::connected_components_gated": "dead CCA variant",
    "graph/cca.py::connected_components_tables": "dead CCA variant",
    "graph/state.py::blank_state": "unused",
    "ops/linalg.py::det2": "unused",
    "ops/linalg.py::inv2": "unused",
    "ops/linalg.py::mat3_mat": "unused",
    "ops/priors.py::reweight": "the unfused reweight, called only by JAX "
                               "tests and tools",
    "parallel/edge_shard.py::edge_mesh": "JAX mesh plumbing; the port "
                                         "takes a process group",
    "parallel/edge_shard.py::graph_pspecs": "JAX partition specs",
    "parallel/edge_shard.py::graph_shardings": "JAX shardings",
    "parallel/edge_shard.py::routing_pspecs": "JAX partition specs",
    "parallel/mesh.py::batched_graph_sharding": "JAX shardings",
    "parallel/mesh.py::shard_batched_graph": "JAX device_put over a mesh; "
                                             "a port rank slices its own "
                                             "events",
}

# JAX file that calls pallas_call -> the port's wrapper and kernel source
KERNELS = {
    "ops/pallas_cluster.py": ("ops/cluster_kernel.py", "csrc/gmr_cluster.cu"),
    "ops/pallas_distinct.py": ("ops/distinct_kernel.py",
                               "csrc/distinct_counts.cu"),
}

MODULES = sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))

# tools/*.py that import the JAX package -> the port's counterpart (a path
# under the repository root) or why it has none: "to port: ..." (ROADMAP's
# queue of tools) or the reason it stays JAX-only
PROFILER = "gnn_track_finding_tpu_torch/profile_stages.py"
TOOLS = {
    "bench_cca.py": "the dead CCA variants; the port runs fixed-round "
                    "FastSV only",
    "bench_cold_stream.py": "to port: cold streams of path-distinct event "
                            "copies through the prefetcher, clean and "
                            "bug_compat",
    "bench_pileup.py": "the v7.device_batch32 cell times stacked events, "
                       "and tests/test_torch_batched.py holds each to its "
                       "single run",
    "bench_prefetch.py": "the benchmark's files driver times the "
                         "prefetched stream, ingest included",
    "capture_trace.py": PROFILER,
    "census_full_schedule.py": "to port: the sharded schedule's event-scale "
                               "bit-match and every iteration's collective "
                               "census in one report",
    "clean_mode_study.py": "to port: clean against bug_compat physics on "
                           "the committed events",
    "jax_runner_constants.py": "computes the JAX package's answers that "
                               "chip_smoke.py carries as constants (the "
                               "card's machine has no JAX)",
    "lut_trackml_study.py": "to port: the KL LUT calibrated on TrackML "
                            "rows, thresholds and labels",
    "multiprocess_schedule.py": "to port: the schedule over two processes "
                                "as a tool (its checks ride in "
                                "tests/test_torch_parallel.py's rank "
                                "worlds and chip_smoke phase 9)",
    "profile_cca_ops.py": PROFILER,
    "profile_cca_variants.py": "the dead CCA variants",
    "profile_cluster_backends.py": "TPU lowering study: XLA against the "
                                   "Pallas clustering backend",
    "profile_edge_shard.py": "reads XLA's compiled HLO; the port counts "
                             "its collectives at run time (ops/collect.py)",
    "profile_extract_parts.py": PROFILER,
    "profile_extrap_parts.py": PROFILER,
    "profile_hot_parts.py": PROFILER,
    "profile_layout.py": "TPU lowering study: (E, 3, 3) tiles against lane "
                         "vectors",
    "profile_lookup_forms.py": "TPU lowering study: two-index lookups",
    "profile_pallas_tiles.py": "TPU lowering study: the Pallas kernel's "
                               "lane tiles",
    "profile_reweight_parts.py": PROFILER,
    "profile_stages.py": PROFILER,
    "pvalue_gaps.py": "compares the port with the JAX package on the CPU, "
                      "as the tests do",
    "roofline.py": PROFILER,
    "sweep_efficiency.py": "to port: the efficiency sweep over the "
                           "reference's CLI parameters",
    "validate_vs_reference.py": "tools/validate_port_vs_reference.py",
}


def _statements(body):
    """Top-level statements, through if / try blocks."""
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
            yield from _statements(node.body)
            yield from _statements(node.orelse)
            for h in getattr(node, "handlers", []):
                yield from _statements(h.body)
            yield from _statements(getattr(node, "finalbody", []))
        else:
            yield node


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _public_defs(path: Path) -> set:
    return {n.name for n in _statements(_tree(path).body)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
            and not n.name.startswith("_")}


def _bound(path: Path) -> set:
    names = set()
    for n in _statements(_tree(path).body):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in n.names)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            names.update(x.id for t in targets for x in ast.walk(t)
                         if isinstance(x, ast.Name))
    return names


def _calls_pallas(path: Path) -> bool:
    return any(isinstance(x, ast.Attribute) and x.attr == "pallas_call"
               or isinstance(x, ast.Name) and x.id == "pallas_call"
               for x in ast.walk(_tree(path)))


@pytest.mark.parametrize("module", MODULES)
def test_module_is_ported(module):
    port = PORT / module
    if module in KERNELS:
        assert all((PORT / f).is_file() for f in KERNELS[module]), module
        return
    if module in NOT_PORTED:
        assert not port.exists(), f"{module} is ported: drop NOT_PORTED"
        return
    assert port.is_file(), f"{module} has no port"
    wanted = _public_defs(JAX / module)
    skipped = {key.split("::")[1] for key in NOT_PORTED
               if key.startswith(module + "::")}
    bound = _bound(port)
    assert not wanted - bound - skipped, (
        f"{module}: not in the port and not in NOT_PORTED: "
        f"{sorted(wanted - bound - skipped)}")
    assert not skipped & bound, (
        f"{module}: ported, drop from NOT_PORTED: {sorted(skipped & bound)}")
    assert skipped <= wanted, (
        f"{module}: NOT_PORTED names what JAX does not define: "
        f"{sorted(skipped - wanted)}")


def test_kernels_are_ported():
    """Every JAX file that calls pallas_call, and no other, is in KERNELS,
    and each has its wrapper and its CUDA source in the port."""
    found = {m for m in MODULES if _calls_pallas(JAX / m)}
    assert found == set(KERNELS)
    for files in KERNELS.values():
        wrapper, source = (PORT / f for f in files)
        assert wrapper.is_file() and source.is_file(), files
        assert "__global__" in source.read_text(), source


def test_not_ported_keys_name_jax_modules():
    assert {key.split("::")[0] for key in NOT_PORTED} <= set(MODULES)
    assert not set(NOT_PORTED) & set(KERNELS)


def _imports_jax_package(path: Path) -> bool:
    for n in ast.walk(_tree(path)):
        names = ([a.name for a in n.names] if isinstance(n, ast.Import)
                 else [n.module or ""] if isinstance(n, ast.ImportFrom)
                 else [])
        if any(m.split(".")[0] == "gnn_track_finding_tpu" for m in names):
            return True
    return False


@pytest.mark.parametrize("tool", sorted(
    p.name for p in (ROOT / "tools").glob("*.py")))
def test_tool_is_mapped(tool):
    """A tool that imports the JAX package is in TOOLS, with a counterpart
    that exists or a reason; no other tool is."""
    if not _imports_jax_package(ROOT / "tools" / tool):
        assert tool not in TOOLS, f"{tool} imports no JAX: drop it"
        return
    assert tool in TOOLS, f"tools/{tool} is not in TOOLS"
    target = TOOLS[tool]
    if target.endswith(".py"):
        assert (ROOT / target).is_file(), target
    else:
        assert len(target.split()) >= 3, f"{tool}: give a reason"


def test_tools_keys_name_tools():
    assert set(TOOLS) <= {p.name for p in (ROOT / "tools").glob("*.py")}
