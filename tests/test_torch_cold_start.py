"""`flexam_tpu_torch/tools/cold_start.py`, the time-to-first-video recipe
(a fresh process, a prequantized int8 npz, the upload levers --overlap,
--upload-threads, --stream-upload, the serve bundle), against JAX's
`tests/test_cold_start.py` on the CPU: the files are written by JAX's
`save_pytree`, so the port's reader is held to JAX's format.

On the CPU the uploads are plain host tensors (no streams) and there are
no kernels: the records' keys, shapes and leaves are checked, not times.
"""

import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu.io.checkpoints import restore_pytree_nested, save_pytree
from flexam_tpu_torch.config import tiny_test_config
from flexam_tpu_torch.io.convert import stack_blocks
from flexam_tpu_torch.models.dit import init_dit_params
from flexam_tpu_torch.models.vae import init_vae_params
from flexam_tpu_torch.tools import cold_start
from flexam_tpu_torch.tools.cold_start import stream_upload_npz


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = tiny_test_config()
TINY = ["--platform", "cpu", "--tiny", "--size", "32", "32", "--frames",
        "9", "--steps", "2"]
# JAX's record, less its link probe (probe_rtt_ms, healthy, probe_done_s),
# plus the kernel library's build at first use
KEYS = ("recipe", "overlap", "upload_threads", "stream_upload", "bundle",
        "npz_load_s", "dit_gb", "upload_s", "vae_init_s", "prepare_s",
        "kernel_build_s", "kernel_build_cached", "denoise_s", "steps_per_s",
        "decode_s", "video_shape", "ttfv_s")


def _np(tree):
    """A port init in JAX's layout (stacked blocks), numpy: JAX's eager
    inits compile op by op."""
    return jax.tree_util.tree_map(lambda t: t.detach().numpy().copy(),
                                  stack_blocks(tree), is_leaf=torch.is_tensor)


def _jax_int8_dit():
    """JAX's prequantized tiny DiT (its prequantize and bf16 cast)."""
    from flexam_tpu.tools.prequant_ckpt import (_cast_wide_to_bf16,
                                                prequantize)
    dit = _np(init_dit_params(CFG.dit, seed=0, dtype=torch.float32,
                              device="cpu"))
    return _cast_wide_to_bf16(prequantize(dit, "int8"))


def _tiny_int8_npz(tmp_path):
    """JAX's tiny prequantized DiT, written by JAX's save_pytree."""
    path = str(tmp_path / "tiny_int8.npz")
    save_pytree(path, _jax_int8_dit())
    return path


def _tiny_bundle_npz(tmp_path):
    """JAX's vae/ + dit/ serve bundle (vae/ written first, bf16)."""
    vae = jax.tree_util.tree_map(
        lambda a: np.asarray(a, jnp.bfloat16),
        _np(init_vae_params(CFG.vae, seed=1, dtype=torch.float32,
                            device="cpu")))
    path = str(tmp_path / "tiny_bundle.npz")
    save_pytree(path, {"vae": vae, "dit": _jax_int8_dit()})
    return path


def _numpy(t):
    """A port leaf as numpy in JAX's dtype names (bf16 through its bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _numpy_jax(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def _same_tree(port, ref):
    """The port's nested tree equals JAX's restore: structure, dtypes,
    shapes and values."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and sorted(port) == sorted(ref)
        for k in ref:
            _same_tree(port[k], ref[k])
        return
    if isinstance(ref, (list, tuple)):
        assert isinstance(port, list) and len(port) == len(ref)
        for a, b in zip(port, ref):
            _same_tree(a, b)
        return
    got, gname = _numpy(port)
    want, wname = _numpy_jax(ref)
    assert gname == wname and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_stream_upload_matches_eager_restore(tmp_path):
    """The pipelined reader reproduces JAX's restore_pytree_nested of a
    file JAX wrote: nesting, dtypes (the bf16 / int8 views), values and
    the byte count."""
    path = _tiny_int8_npz(tmp_path)
    eager = restore_pytree_nested(path)
    streamed, nb = stream_upload_npz(path, n_threads=3, device="cpu")
    _same_tree(streamed, eager)
    assert nb == sum(a.nbytes for a in jax.tree_util.tree_leaves(eager))


def test_stream_upload_cast_matches_put_quantized(tmp_path):
    """cast_wide_prefix gives the leaf dtypes of JAX's restore +
    `_put_quantized` (the port's `_put_quantized` applies the same rule to
    host leaves crossing to the card; on a CPU pipeline they stay as they
    are)."""
    from flexam_tpu.pipeline import _put_quantized as jax_put
    rng = np.random.RandomState(0)
    tree = {
        "q": {"weight": rng.rand(8, 8).astype(np.float32),
              "bias": rng.rand(8).astype(np.float32)},
        "blk": {"weight_q": rng.randint(-127, 128, (8, 8)).astype(np.int8),
                "w_scale": rng.rand(8, 1).astype(np.float32)},
    }
    path = str(tmp_path / "mixed.npz")
    save_pytree(path, tree)
    streamed, _ = stream_upload_npz(path, n_threads=2, cast_wide_prefix="",
                                    device="cpu")
    jref = jax_put(restore_pytree_nested(path))

    def dtypes(tree):
        return {f"{a}/{b}": str(np.asarray(v).dtype if not torch.is_tensor(v)
                                else v.dtype).replace("torch.", "")
                for a, sub in tree.items() for b, v in sub.items()}
    assert dtypes(streamed) == dtypes(jref) == {
        "q/weight": "bfloat16", "q/bias": "float32", "blk/weight_q": "int8",
        "blk/w_scale": "float32"}


def test_stream_upload_priority_callback(tmp_path):
    """A bundle's vae/ members arrive first and fire the callback before
    the whole tree returns; its subtree equals JAX's restored vae."""
    path = _tiny_bundle_npz(tmp_path)
    got = {}
    streamed, _ = stream_upload_npz(
        path, n_threads=2, priority_prefix="vae/",
        on_priority_ready=lambda sub: got.update(vae=sub),
        device="cpu")
    assert "vae" in got, "the priority callback never fired"
    eager = restore_pytree_nested(path)
    _same_tree(got["vae"], eager["vae"])
    _same_tree(streamed, eager)


def _run(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cold_start.main(argv)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cold_start_tiny_bundle_e2e(tmp_path):
    """The serve-bundle recipe end to end: the VAE arrives by stream (no
    random init) and the record marks the bundle. The port's own
    --make-prequant --with-vae writes a bundle that JAX's reader restores
    and the port serves."""
    rec = _run(["--prequant", _tiny_bundle_npz(tmp_path), *TINY,
                "--stream-upload", "--overlap", "--upload-threads", "2"])
    assert rec["bundle"] is True and "vae_upload_done_s" in rec
    assert rec["video_shape"] == [1, 3, 9, 32, 32]
    own = str(tmp_path / "own_bundle.npz")
    assert cold_start.main(["--make-prequant", own, "--with-vae",
                            *TINY]) == 0
    tree = restore_pytree_nested(own)
    assert list(tree) == ["vae", "dit"]
    assert tree["dit"]["blocks"]["self_attn"]["q"]["weight_q"].dtype == np.int8
    rec = _run(["--prequant", own, *TINY, "--upload-threads", "2"])
    assert rec["bundle"] is True and rec["video_shape"] == [1, 3, 9, 32, 32]


@pytest.mark.parametrize("levers", [
    ("--stream-upload", "--overlap", "--upload-threads", "2"), ()],
    ids=["all", "none"])
def test_cold_start_tiny_e2e(tmp_path, levers):
    """The recipe at tiny size with every lever on, and with none: stream
    upload overlapped with prepare -> denoise -> decode; the record
    carries every stage and the levers."""
    rec = _run(["--prequant", _tiny_int8_npz(tmp_path), *TINY, *levers])
    on = bool(levers)
    assert rec["stream_upload"] is on and rec["overlap"] is on
    assert rec["video_shape"] == [1, 3, 9, 32, 32]
    for k in KEYS:
        assert k in rec, k
    assert ("upload_join_s" in rec) is on and rec["bundle"] is False
    assert rec["kernel_build_s"] is None            # no kernels on the CPU
    assert rec["ttfv_s"] > rec["denoise_s"] > 0
