"""The port's package surface against the JAX package's (ROADMAP C2): each
`__init__` of `flexam_tpu_torch` exports the public names of its
`flexam_tpu` counterpart, except an explicit list of names whose modules
wait for unported ROADMAP items; so does the node pack (`nodes`). The top level's names are JAX's lazy
`__getattr__` ones plus its eager ones. `make_sampler` is driven as
`tests/test_sampling.py:9,21` drives JAX's.
"""

import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexam_tpu
import flexam_tpu_torch

# names of the JAX package whose modules are not ported yet, by ROADMAP item
WAITING = {}
# JAX's lazy perception names whose models are not ported yet, by ROADMAP
# item (none since DWPose and the pose renderer)
PERCEPTION_WAITING = {}
# JAX's lazy top-level API (`flexam_tpu/__init__.py` `__getattr__`)
LAZY = ("FlexAMGenerationPipeline", "FlexAMModels", "FlexAMOrchestrator",
        "FirstFrameRepainter")
SUBPACKAGES = ["", ".ops", ".core", ".models", ".utils", ".sampling",
               ".conditioning", ".io", ".perception"]


def _lazy_perception_names():
    """The names JAX's `flexam_tpu/perception/__init__.py` `__getattr__`
    resolves (its `name in (...)` tuples), read from the source."""
    import ast
    from pathlib import Path
    src = Path(flexam_tpu.__file__).parent / "perception" / "__init__.py"
    fn = next(n for n in ast.parse(src.read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == "__getattr__")
    return sorted(e.value for node in ast.walk(fn)
                  if isinstance(node, ast.Compare)
                  and isinstance(node.ops[0], ast.In)
                  and isinstance(node.comparators[0], ast.Tuple)
                  for e in node.comparators[0].elts)


LAZY_PERCEPTION = _lazy_perception_names()


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top")
def test_init_exports_match_jax(sub):
    jmod = importlib.import_module("flexam_tpu" + sub)
    tmod = importlib.import_module("flexam_tpu_torch" + sub)
    want = _public(jmod) | (set(LAZY) if not sub else set())
    waiting = WAITING.get(sub, set())
    missing = {n for n in want - waiting if not hasattr(tmod, n)}
    assert not missing, f"flexam_tpu_torch{sub} lacks {sorted(missing)}"
    # a waiting name that has been ported must leave the list
    assert not {n for n in waiting if hasattr(tmod, n)}, waiting
    for n in want - waiting:
        obj = getattr(tmod, n)
        assert not isinstance(obj, types.ModuleType), n
        assert callable(obj) or not callable(getattr(jmod, n, obj)), n


def test_nodes_exports_match_jax():
    """`flexam_tpu_torch.nodes` exports every public name of
    `flexam_tpu.nodes` (the node classes, the mappings, the annotator
    registry, the bucket helpers), less the typing names it imports."""
    import typing
    jmod = importlib.import_module("flexam_tpu.nodes")
    tmod = importlib.import_module("flexam_tpu_torch.nodes")
    want = {n for n in _public(jmod)
            if getattr(typing, n, None) is not getattr(jmod, n)
            and n != "annotations"}
    missing = {n for n in want if not hasattr(tmod, n)}
    assert not missing, f"flexam_tpu_torch.nodes lacks {sorted(missing)}"
    for n in want:
        assert callable(getattr(tmod, n)) == callable(getattr(jmod, n)), n
    assert set(tmod.NODE_CLASS_MAPPINGS) == set(jmod.NODE_CLASS_MAPPINGS)


def test_top_level_is_lazy_and_versioned():
    assert flexam_tpu_torch.__version__ == flexam_tpu.__version__
    from flexam_tpu_torch.orchestrator import FlexAMOrchestrator
    from flexam_tpu_torch.pipeline import (FlexAMGenerationPipeline,
                                           FlexAMModels)
    assert flexam_tpu_torch.FlexAMGenerationPipeline is FlexAMGenerationPipeline
    assert flexam_tpu_torch.FlexAMModels is FlexAMModels
    assert flexam_tpu_torch.FlexAMOrchestrator is FlexAMOrchestrator
    from flexam_tpu_torch.repaint import FirstFrameRepainter
    assert flexam_tpu_torch.FirstFrameRepainter is FirstFrameRepainter
    with pytest.raises(AttributeError):
        flexam_tpu_torch.NoSuchName


def test_ops_names_functions_after_counters():
    """`ops.flash_attention` is the function, as in JAX, and the launch
    counters still read the kernel modules."""
    import flexam_tpu_torch.ops as ops
    fa_mod = importlib.import_module("flexam_tpu_torch.ops.flash_attention")
    assert ops.flash_attention is fa_mod.flash_attention
    assert ops.int8_flash_attention is ops.int8_attention.int8_attention
    assert ops._COUNTERS[0] is fa_mod.launches
    ops.reset_launch_counts()
    assert set(ops.launch_counts()) >= {"flash_attention", "int8_attention"}
    q = torch.randn(1, 8, 1, 128)
    out = ops.flash_attention(q, q, q)
    assert out.shape == q.shape and ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("kind,order", [("flow_match_euler", 1),
                                        ("flow_unipc", 2), ("flow_dpm", 2)])
def test_make_sampler_matches_jax(kind, order):
    """`make_sampler(tables)` steps as JAX's (`tests/test_sampling.py:21`):
    the same x after every step on the same velocities."""
    from flexam_tpu.sampling import build_schedule as jbuild
    from flexam_tpu.sampling import make_sampler as jmake
    from flexam_tpu_torch.sampling import build_schedule, make_sampler

    rs = np.random.RandomState(0)
    x0 = rs.randn(1, 4, 2, 4, 4).astype(np.float32)
    vels = [rs.randn(*x0.shape).astype(np.float32) for _ in range(6)]
    jinit, jstep = jmake(jbuild(kind, 6, shift=5.0, solver_order=order))
    tinit, tstep = make_sampler(build_schedule(kind, 6, shift=5.0,
                                               solver_order=order))
    js, ts = jinit(jnp.asarray(x0)), tinit(torch.from_numpy(x0))
    for i, v in enumerate(vels):
        js, jx = jstep(js, jnp.asarray(v), np.int32(i))
        ts, tx = tstep(ts, torch.from_numpy(v), np.int32(i))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("name", LAZY_PERCEPTION)
def test_lazy_perception_names_match_jax(name):
    """Every model name JAX's perception package resolves lazily resolves in
    the port's too (MoGe, VGGT, Pi3, DenseTrack3D, UniDepth, the flow
    tracker, DWPose and the pose renderer), to the object of the port's model module; a name of a model
    not ported yet is absent, and listed in PERCEPTION_WAITING."""
    import flexam_tpu.perception as jperc
    import flexam_tpu_torch.perception as tperc
    assert set(PERCEPTION_WAITING) <= set(LAZY_PERCEPTION)
    if name in PERCEPTION_WAITING:
        assert not hasattr(tperc, name)
        return
    obj = getattr(tperc, name)
    assert callable(obj) and callable(getattr(jperc, name))
    assert obj.__module__.startswith("flexam_tpu_torch.perception.")
    assert getattr(importlib.import_module(obj.__module__), name) is obj


@pytest.mark.parametrize("module,name", [
    ("moge", "moge_init"), ("depth_anything", "dav2_init"),
    ("pi3", "pi3_init"), ("densetrack3d", "densetrack3d_init"),
    ("unidepth", "unidepth_init"), ("vggt", "vggt_init"),
    ("zoedepth", "zoedepth_init")])
def test_perception_inits_default_to_cuda(module, name):
    """The counterparts of JAX's `*_init(key, cfg)` default to the card, as
    the other entry points do: called bare without CUDA they raise instead
    of drawing a model on the CPU."""
    import inspect
    fn = getattr(importlib.import_module(
        f"flexam_tpu_torch.perception.{module}"), name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(torch.Generator(), None)


def test_no_raise_left_for_ported_items():
    """No NotImplementedError of the port names ROADMAP item 7 or A14 any
    more (FLUX, the SVD kinds, the onnx and depthcrafter backends are
    ported); A15's by-design refusals stay."""
    from pathlib import Path
    root = Path(flexam_tpu_torch.__file__).parent
    hits = []
    for p in root.rglob("*.py"):
        text = p.read_text()
        for tag in ("item 7", "A14"):
            if tag in text and "NotImplementedError" in text:
                hits += [f"{p.name}: {line.strip()}"
                         for line in text.splitlines() if tag in line]
    assert not hits, hits
