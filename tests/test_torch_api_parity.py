"""API parity of the whole package: every public name of every module of
the JAX package ``opticalflowcontainer_tpu/`` (each top-level function or
class whose name has no leading underscore, and each name in ``__all__``)
has a counterpart of the same name in the same module of the port
``opticalflowcontainer_tpu_torch/``, with two kinds of exception:

- ``RENAMES``: a counterpart under another name or in another module (the
  plain correlation for ``correlation_lax``, the CUDA kernels' wrappers for
  the Pallas kernels, the packaged-weight loaders gathered in
  ``models/convert.py``);
- ``EXEMPT``: a name with no counterpart, and why it has none: either the
  TPU or XLA mechanism that makes it one, or a measurement (a latency
  driver, a byte count, a roofline tool) that the benchmark ``portbench/``
  makes of the port, so the program carries none of its own.

Both lists fail when they go stale: a JAX name that no longer exists, a
rename whose target is missing, or an exemption (or rename) for a name the
port now has under JAX's own name.  Where a JAX module has ``__all__``,
the port's module exports each counterpart in its own ``__all__``.  The
trees are read with ``ast``: nothing of either package is imported.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "opticalflowcontainer_tpu"
PORT = ROOT / "opticalflowcontainer_tpu_torch"

# (JAX module, name) -> (port module, name)
RENAMES = {
    ("models/common.py", "load_flat_npz"): ("models/convert.py", "load_flat_npz"),
    ("models/common.py", "convert_torch_conv"): ("models/convert.py", "flax_conv_kernel"),
    ("models/common.py", "convert_torch_deconv"): ("models/convert.py",
                                                   "flax_deconv_kernel"),
    ("models/pwcnet.py", "load_pwcnet_synth"): ("models/convert.py", "load_pwcnet_synth"),
    ("models/liteflownet.py", "load_liteflownet_synth"): ("models/convert.py",
                                                          "load_liteflownet_synth"),
    ("models/liteflownet3.py", "load_liteflownet3_synth"): ("models/convert.py",
                                                            "load_liteflownet3_synth"),
    ("models/raft.py", "load_raft_small_synth"): ("models/convert.py",
                                                  "load_raft_small_synth"),
    ("models/raft.py", "load_raft_synth"): ("models/convert.py", "load_raft_synth"),
    ("models/neuflow.py", "load_neuflow_lite_synth"): ("models/convert.py",
                                                       "load_neuflow_lite_synth"),
    ("models/neuflow_v2.py", "load_neuflow_v2_synth"): ("models/convert.py",
                                                        "load_neuflow_v2_synth"),
    ("models/raft.py", "InstanceNorm"): ("models/raft.py", "instance_norm"),
    ("ops/__init__.py", "correlation_lax"): ("ops/__init__.py", "correlation_plain"),
    ("ops/correlation.py", "correlation_lax"): ("ops/correlation.py", "correlation_plain"),
    # the four Pallas kernels: K4, K3 (and its plain reference), K1, K2
    ("ops/correlation_pallas.py", "correlation_pallas"): ("ops/correlation.py",
                                                          "local_correlation"),
    ("ops/blockwarp.py", "block_warp_bilinear"): ("ops/warp_bilinear.py", "warp_bilinear"),
    ("ops/blockwarp.py", "block_warp_bilinear_reference"): ("ops/warp_bilinear.py",
                                                            "warp_bilinear_plain"),
    ("ops/blockwarp.py", "block_warp_farneback_update"): ("ops/farneback_update.py",
                                                          "farneback_update"),
    ("ops/solve2x2.py", "blur_solve_2x2"): ("ops/solve2x2.py", "blur_solve"),
}

_BANDED = ("core/banded.py: dense banded operator matrices built on the device "
           "for the TPU's MXU matmul form of the separable filters and resizes; "
           "the port sums shifted slices")
_MEASURED = "measured by `portbench/` ({}), not by the program"
_STREAM = _MEASURED.format("loops/stream.py")
_BYTES = _MEASURED.format("counts/farneback.py")
_CACHE = ("utils/compile_cache.py: ships XLA's persistent compile cache for the "
          "TPU's remote compiles; the port compiles its kernels with nvcc")
EXEMPT = {
    ("classical/farneback.py", "share_mode"):
        "the gate between the TPU block-warp programs' all-levels and finest-level "
        "plane sharing (an XLA fusion blow-up at 1080p); the port has one mode",
    ("core/backend.py", "on_tpu"):
        "core/backend.py: chooses the TPU's MXU matmul forms by JAX's backend",
    ("core/banded.py", "apply_banded_h"): _BANDED,
    ("core/banded.py", "apply_banded_v"): _BANDED,
    ("core/banded.py", "as_operator"): _BANDED,
    ("core/banded.py", "materialize_banded"): _BANDED,
    ("utils/compile_cache.py", "export"): _CACHE,
    ("utils/compile_cache.py", "restore"): _CACHE,
    ("utils/compile_cache.py", "run_start_marker"): _CACHE,
    ("ops/blockwarp.py", "split3_bf16"):
        "ops/blockwarp.py helper: exact fp32 maps as three bf16 MXU matmuls",
    ("ops/blockwarp.py", "start_prefetch_pipeline"):
        "ops/blockwarp.py helper: the Pallas kernels' double-buffered DMA steps",
    ("ops/correlation.py", "local_correlation_jit"):
        "jax.jit of local_correlation; the port has no tracing step",
    ("ops/allpairs.py", "pack_corr_pyramid"):
        "pack_corr_pyramid: the TPU gather layout of RAFT's pyramid in y-window "
        "fat rows (the port's ops/allpairs.py packs for one flat gather instead)",
    ("ops/__init__.py", "pack_corr_pyramid"):
        "pack_corr_pyramid: the TPU gather layout, as in ops/allpairs.py",
    ("runtime/fused.py", "measure_stream_latency"): _STREAM,
    ("runtime/fused.py", "measure_device_stream_ms"): _STREAM,
    ("runtime/__init__.py", "measure_stream_latency"): _STREAM,
    ("classical/farneback.py", "farneback_traffic_breakdown"): _BYTES,
    ("classical/farneback.py", "farneback_bytes_per_field"): _BYTES,
    ("tools/stage_roofline.py", "main"): _MEASURED.format(
        "counts/farneback.py, metrics/*_roofline.py"),
}


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def public_names(path: pathlib.Path) -> tuple[set, list | None]:
    """The module's public top-level functions and classes, and its
    ``__all__`` (None without one)."""
    names, all_ = set(), None
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                names.add(node.name)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            all_ = [ast.literal_eval(e) for e in node.value.elts]
    return names, all_


def bound_names(path: pathlib.Path) -> set:
    """Every name the module binds at its top level, in its body or under a
    top-level ``if`` / ``try``: definitions, assignments and imports."""
    out = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                out.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                out.update(n.id for t in targets for n in ast.walk(t)
                           if isinstance(n, ast.Name))
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                out.update((a.asname or a.name).split(".")[0] for a in node.names)
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body)
                visit(node.orelse)
                for h in getattr(node, "handlers", []):
                    visit(h.body)

    visit(_tree(path).body)
    return out


def jax_modules() -> list[str]:
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def jax_public(module: str) -> set:
    names, all_ = public_names(JAX / module)
    return names | set(all_ or ())


def port_has(module: str, name: str) -> bool:
    path = PORT / module
    return path.is_file() and name in bound_names(path)


def _group(module: str) -> str:
    return module.split("/")[0] if "/" in module else "(top)"


GROUPS = sorted({_group(m) for m in jax_modules()})


def test_the_groups_cover_the_package():
    assert {"classical", "core", "eval", "models", "ops", "parallel", "runtime",
            "tools", "utils"} <= set(GROUPS)


@pytest.mark.parametrize("group", GROUPS)
def test_every_public_jax_name_has_a_counterpart(group):
    missing = []
    for module in (m for m in jax_modules() if _group(m) == group):
        for name in sorted(jax_public(module)):
            key = (module, name)
            if key in EXEMPT:
                continue
            target = RENAMES.get(key, (module, name))
            if not port_has(*target):
                missing.append(f"{module}:{name} -> {target[0]}:{target[1]}")
    assert missing == []


@pytest.mark.parametrize("group", GROUPS)
def test_the_port_exports_what_the_jax_module_exports(group):
    """Where a JAX module has ``__all__``, the port's module lists the
    counterpart of each name in its own (a rename into another module
    excepted)."""
    missing = []
    for module in (m for m in jax_modules() if _group(m) == group):
        _, ref_all = public_names(JAX / module)
        if ref_all is None:
            continue
        _, port_all = public_names(PORT / module)
        for name in ref_all:
            if (module, name) in EXEMPT:
                continue
            target = RENAMES.get((module, name), (module, name))
            if target[0] == module and target[1] not in (port_all or ()):
                missing.append(f"{module}:{name} -> {target[1]}")
    assert missing == []


@pytest.mark.parametrize("key", sorted(EXEMPT), ids=lambda k: f"{k[0]}:{k[1]}")
def test_no_exemption_is_stale(key):
    """An exempt name still exists in the JAX module, the port still lacks
    it, and the reason names the mechanism."""
    module, name = key
    assert name in jax_public(module), f"{module} no longer has {name}"
    assert not port_has(module, name), f"the port now has {module}:{name}"
    assert len(EXEMPT[key]) > 20


def test_no_rename_is_stale():
    """Each renamed JAX name still exists, its target exists in the port,
    and the port does not also have JAX's name in JAX's module."""
    stale = []
    for (module, name), target in sorted(RENAMES.items()):
        if name not in jax_public(module):
            stale.append(f"{module}:{name} is gone from the JAX package")
        if not port_has(*target):
            stale.append(f"{target[0]}:{target[1]} is missing from the port")
        if target != (module, name) and port_has(module, name):
            stale.append(f"the port now has {module}:{name} itself")
    assert stale == []
    assert not set(RENAMES) & set(EXEMPT)


def test_the_checker_sees_a_missing_name(tmp_path):
    """The AST readers on a module of known content: a public function, a
    class, ``__all__``, and names bound by imports and under ``try``."""
    src = tmp_path / "m.py"
    src.write_text("from .x import a as b\nimport c.d\n__all__ = ['f', 'b']\n"
                   "def f(): pass\ndef _g(): pass\nclass K: pass\n"
                   "try:\n    import e\nexcept ImportError:\n    h = 1\n")
    assert public_names(src) == ({"f", "K"}, ["f", "b"])
    assert bound_names(src) == {"b", "c", "__all__", "f", "_g", "K", "e", "h"}
