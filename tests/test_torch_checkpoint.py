"""Port parity: ``repro_torch.checkpoint.checkpoint`` against
``repro.checkpoint.checkpoint``.

The first part mirrors ``tests/test_checkpoint.py`` case for case, port
against port: round trips, manifest contents, bf16 leaves, the
``pod_resize`` grow and shrink paths, every refusal, ``_resize_pod_dim``,
and the atomic commit with its corruption errors.  The second part holds
the format to the reference's:
a ``TrainState`` and a parameter tree written by either package restore in
the other bit for bit (bf16 leaves included, and through ``pod_resize``),
with the same keys, dtypes, shapes and step in the manifest, and the
port's CRC32, assembled from pieces, equals ``zlib.crc32`` of the whole
file.  The pod-dimension means are the reference's numpy expressions on
the same arrays, so they are bit-equal too.  The reference's two topology
cases close it: a reference checkpoint restored into a 3-pod run over a
``HierarchicalTransport``, and one file restored under flat and
hierarchical trainers to the same values.
"""
import json
import random
import zipfile
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import sync as jsync
from repro.training.trainer import Trainer as JTrainer
from repro.training.trainer import TrainerConfig as JTrainerConfig
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.sync import SyncConfig
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)


def _tree(n_pods, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.normal(size=(n_pods, 6, 3))
                              .astype(np.float32)),
        "opt": {"m": torch.from_numpy(rng.normal(size=(n_pods, 6, 3))
                                      .astype(np.float32))},
        "bias": torch.from_numpy(rng.normal(size=(n_pods, 3))
                                 .astype(np.float32)),
    }


def _zeros(tree, n_pods=None):
    return T.tree_map(lambda x: torch.zeros(
        ((n_pods,) + tuple(x.shape[1:])) if n_pods else x.shape,
        dtype=x.dtype), tree)


def _equal(a, b):
    for x, y in zip(T.leaves(a), T.leaves(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ------------------------------------------------------------- round trips


def test_save_restore_roundtrip_same_size(tmp_path):
    tree = _tree(3)
    ckpt.save(str(tmp_path), tree, step=17, metadata={"model": "t"})
    out, step = ckpt.restore(str(tmp_path), _zeros(tree))
    assert step == 17
    _equal(tree, out)


def test_manifest_contents(tmp_path):
    tree = _tree(2)
    ckpt.save(str(tmp_path), tree, step=5, metadata={"pods": 2})
    m = ckpt.load_manifest(str(tmp_path))
    assert m["step"] == 5
    assert m["metadata"] == {"pods": 2}
    assert set(m["keys"]) == {"w", "opt/m", "bias"}
    assert all(d == "float32" for d in m["dtypes"])


def test_bf16_leaves_roundtrip_via_fp32(tmp_path):
    """bf16 stores upcast (lossless) and restores back to bf16 exactly."""
    tree = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 8)).astype(np.float32)).to(torch.bfloat16)}
    ckpt.save(str(tmp_path), tree, step=1)
    m = ckpt.load_manifest(str(tmp_path))
    assert m["dtypes"] == ["bfloat16"]
    with np.load(tmp_path / "arrays.npz") as data:
        assert data["a0"].dtype == np.float32
    out, _ = ckpt.restore(str(tmp_path), _zeros(tree))
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(tree["w"], out["w"])


def test_same_size_roundtrip_with_pod_resize_flag(tmp_path):
    """pod_resize on a matching-size restore is a no-op, any mode."""
    tree = _tree(3)
    ckpt.save(str(tmp_path), tree, step=2)
    for mode in ("mean", "clone", "drop"):
        out, _ = ckpt.restore(str(tmp_path), _zeros(tree), pod_resize=mode)
        _equal(tree, out)


# ------------------------------------------------------------- grow paths


def test_grow_mean_seeds_joiners_with_mean_replica(tmp_path):
    tree = _tree(2)
    ckpt.save(str(tmp_path), tree, step=3)
    out, _ = ckpt.restore(str(tmp_path), _zeros(tree, 4), pod_resize="mean")
    for old, new in zip(T.leaves(tree), T.leaves(out)):
        old, new = old.numpy(), new.numpy()
        assert new.shape[0] == 4
        np.testing.assert_array_equal(new[:2], old)       # survivors exact
        want = old.astype(np.float32).mean(axis=0)
        np.testing.assert_allclose(new[2], want, rtol=1e-6)
        np.testing.assert_array_equal(new[2], new[3])     # all joiners alike
        np.testing.assert_allclose(new.mean(axis=0), want, rtol=1e-6)


def test_grow_clone_seeds_joiners_with_pod0(tmp_path):
    tree = _tree(2)
    ckpt.save(str(tmp_path), tree, step=3)
    out, _ = ckpt.restore(str(tmp_path), _zeros(tree, 3), pod_resize="clone")
    for old, new in zip(T.leaves(tree), T.leaves(out)):
        assert torch.equal(new[2], old[0])


def test_grow_drop_refuses(tmp_path):
    tree = _tree(2)
    ckpt.save(str(tmp_path), tree, step=0)
    with pytest.raises(ValueError, match="cannot grow"):
        ckpt.restore(str(tmp_path), _zeros(tree, 4), pod_resize="drop")


# ----------------------------------------------------------- shrink paths


def test_shrink_mean_preserves_global_mean(tmp_path):
    tree = _tree(4)
    ckpt.save(str(tmp_path), tree, step=9)
    out, step = ckpt.restore(str(tmp_path), _zeros(tree, 2),
                             pod_resize="mean")
    assert step == 9
    for old, new in zip(T.leaves(tree), T.leaves(out)):
        old, new = old.numpy(), new.numpy()
        assert new.shape[0] == 2
        np.testing.assert_allclose(new.mean(axis=0), old.mean(axis=0),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(new[0] - new[1], old[0] - old[1],
                                   rtol=1e-5, atol=1e-6)


def test_shrink_drop_keeps_first_pods_verbatim(tmp_path):
    tree = _tree(4)
    ckpt.save(str(tmp_path), tree, step=0)
    for mode in ("drop", "clone"):   # both shrink by plain truncation
        out, _ = ckpt.restore(str(tmp_path), _zeros(tree, 2),
                              pod_resize=mode)
        for old, new in zip(T.leaves(tree), T.leaves(out)):
            assert torch.equal(new, old[:2])


# ---------------------------------------------------------- refusal paths


def test_restore_without_pod_resize_refuses_mismatch(tmp_path):
    tree = _tree(2)
    ckpt.save(str(tmp_path), tree, step=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), _zeros(tree, 3))


def test_restore_refuses_trailing_dim_mismatch(tmp_path):
    """pod_resize covers only the leading dim: a trailing-dim change is a
    different model and must refuse, not silently resize."""
    ckpt.save(str(tmp_path), {"w": torch.zeros(2, 6, 3)}, step=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(4, 6, 5)},
                     pod_resize="mean")


def test_restore_refuses_unknown_mode_and_missing_leaf(tmp_path):
    tree = _tree(2)
    ckpt.save(str(tmp_path), tree, step=0)
    with pytest.raises(ValueError, match="unknown pod_resize"):
        ckpt.restore(str(tmp_path), tree, pod_resize="median")
    like = dict(tree)
    like["extra"] = torch.zeros(2, 3)
    with pytest.raises(KeyError, match="extra"):
        ckpt.restore(str(tmp_path), like)


# ----------------------------------------------- _resize_pod_dim directly


def test_resize_pod_dim_grow_drop_raises():
    with pytest.raises(ValueError, match="cannot grow"):
        ckpt._resize_pod_dim(np.zeros((2, 4), np.float32), 3, "drop")


def test_resize_pod_dim_shrink_to_one_mean_is_global_mean():
    arr = np.random.default_rng(0).normal(size=(4, 5, 2)).astype(np.float32)
    out = ckpt._resize_pod_dim(arr, 1, "mean")
    assert out.shape == (1, 5, 2)
    np.testing.assert_allclose(out[0], arr.mean(axis=0), rtol=1e-6,
                               atol=1e-7)


def test_resize_pod_dim_bf16_roundtrip_keeps_dtype():
    """The mean math upcasts through fp32 but the result keeps the input's
    dtype, growing and shrinking (numpy bf16 from ml_dtypes: the port's
    code names no dtype of its own)."""
    arr = np.random.default_rng(1).normal(size=(2, 8)).astype(
        ml_dtypes.bfloat16)
    grown = ckpt._resize_pod_dim(arr, 4, "mean")
    assert grown.dtype == arr.dtype and grown.shape == (4, 8)
    np.testing.assert_array_equal(grown[:2], arr)
    shrunk = ckpt._resize_pod_dim(grown, 2, "mean")
    assert shrunk.dtype == arr.dtype and shrunk.shape == (2, 8)
    for got, want in ((grown, jckpt._resize_pod_dim(arr, 4, "mean")),
                      (shrunk, jckpt._resize_pod_dim(grown, 2, "mean"))):
        np.testing.assert_array_equal(got.view(np.uint16),
                                      want.view(np.uint16))


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("n_old,n_new", [(2, 1), (3, 1), (4, 2), (5, 3)])
def test_resize_pod_dim_mean_shrink_is_the_references_bits(n_old, n_new,
                                                           dtype):
    """The mean shrink forms its shift in place with fewer temporaries;
    its values are the reference's expression's, bit for bit, in the
    input's dtype, and the input is left as it was."""
    rng = np.random.default_rng(n_old * 10 + n_new)
    arr = (rng.normal(size=(n_old, 6, 5)) * 100).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    before = arr.copy()
    got = ckpt._resize_pod_dim(arr, n_new, "mean")
    want = jckpt._resize_pod_dim(arr, n_new, "mean")
    assert got.dtype == want.dtype == arr.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    np.testing.assert_array_equal(arr.view(np.uint8), before.view(np.uint8))


def test_resize_pod_dim_same_size_is_identity():
    arr = np.random.default_rng(2).normal(size=(3, 4)).astype(np.float32)
    for mode in ("mean", "clone", "drop"):
        assert ckpt._resize_pod_dim(arr, 3, mode) is arr


# ------------------------------------------------ atomicity & corruption


def test_save_leaves_no_staging_dir(tmp_path):
    d = tmp_path / "ck"
    ckpt.save(str(d), _tree(2), step=1)
    assert sorted(p.name for p in d.iterdir()) == ["arrays.npz",
                                                   "manifest.json"]
    assert [p.name for p in tmp_path.iterdir()] == ["ck"]


def test_truncated_arrays_raise_named_corruption_error(tmp_path):
    tree = _tree(2)
    ckpt.save(str(tmp_path), tree, step=7)
    apath = tmp_path / "arrays.npz"
    blob = apath.read_bytes()
    apath.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(str(tmp_path), _zeros(tree))


@pytest.mark.parametrize("where", [0.5, 0.05, 0.97])
def test_corrupted_arrays_same_length_raise_via_crc(tmp_path, where):
    """Bit rot that keeps the byte count is caught by the manifest CRC,
    wherever it lands: in an array, a member header or the central
    directory (the last two also stop the file from parsing)."""
    tree = _tree(2)
    ckpt.save(str(tmp_path), tree, step=7)
    apath = tmp_path / "arrays.npz"
    blob = bytearray(apath.read_bytes())
    blob[int(len(blob) * where)] ^= 0xFF
    apath.write_bytes(bytes(blob))
    with pytest.raises(ckpt.CheckpointCorruptError, match="CRC"):
        ckpt.restore(str(tmp_path), _zeros(tree))


def test_missing_arrays_raise_corruption_error(tmp_path):
    tree = _tree(2)
    ckpt.save(str(tmp_path), tree, step=7)
    (tmp_path / "arrays.npz").unlink()
    with pytest.raises(ckpt.CheckpointCorruptError, match="no arrays.npz"):
        ckpt.restore(str(tmp_path), _zeros(tree))


def test_garbage_manifest_raises_corruption_error(tmp_path):
    ckpt.save(str(tmp_path), _tree(2), step=7)
    (tmp_path / "manifest.json").write_text("{not json")
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_manifest(str(tmp_path))


def test_old_manifest_without_commit_record_still_loads(tmp_path):
    """Manifests without the commit record (no arrays_bytes/crc32) keep
    restoring; each member is then held to its own zip CRC."""
    tree = _tree(2)
    ckpt.save(str(tmp_path), tree, step=4)
    mpath = tmp_path / "manifest.json"
    m = json.loads(mpath.read_text())
    m.pop("arrays_bytes"), m.pop("arrays_crc32")
    mpath.write_text(json.dumps(m))
    out, step = ckpt.restore(str(tmp_path), _zeros(tree))
    assert step == 4
    _equal(tree, out)
    # a flipped value in the last member then fails that member's CRC
    apath = tmp_path / "arrays.npz"
    with open(apath, "rb") as f, zipfile.ZipFile(f) as zf:
        info, off = ckpt._members(f, zf)[-1]
    blob = bytearray(apath.read_bytes())
    blob[off + info.file_size - 1] ^= 0xFF
    apath.write_bytes(bytes(blob))
    with pytest.raises(ckpt.CheckpointCorruptError, match="CRC"):
        ckpt.restore(str(tmp_path), _zeros(tree))


# ------------------------------------------------- the CRC from its pieces


def test_crc32_combine_equals_zlib():
    rng = random.Random(0)
    for _ in range(100):
        a = rng.randbytes(rng.randint(0, 4000))
        b = rng.randbytes(rng.randint(0, 4000))
        assert ckpt.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) \
            == zlib.crc32(a + b)
    b = bytes(3 << 20)
    assert ckpt.crc32_combine(zlib.crc32(b"x"), zlib.crc32(b), len(b)) \
        == zlib.crc32(b"x" + b)


def test_manifest_crc_is_the_whole_files(tmp_path, monkeypatch):
    """The CRC assembled from the members' zip CRCs and the bytes between
    them is ``zlib.crc32`` of the file; so is the one a restore assembles
    from its threads' chunks (one chunk is 4 KiB here, so the members
    split into many)."""
    monkeypatch.setattr(ckpt, "_CHUNK", 4096)
    rng = np.random.default_rng(4)
    tree = {"a": torch.from_numpy(rng.normal(size=(2, 7000))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32)),
            "c": torch.zeros(0), "d": torch.arange(5, dtype=torch.int32)}
    ckpt.save(str(tmp_path), tree, step=3)
    m = ckpt.load_manifest(str(tmp_path))
    blob = (tmp_path / "arrays.npz").read_bytes()
    assert m["arrays_bytes"] == len(blob)
    assert m["arrays_crc32"] == zlib.crc32(blob)
    out, _ = ckpt.restore(str(tmp_path), _zeros(tree))
    _equal(tree, out)


@pytest.mark.parametrize("zip64_limit,count_limit", [
    ((1 << 31) - 1, (1 << 16) - 1), (200, (1 << 16) - 1), (1000, 2)])
def test_archive_is_np_savez_bytes_at_the_epoch(tmp_path, monkeypatch,
                                                zip64_limit, count_limit):
    """With zipfile's clock at the zip epoch, at which the port dates every
    member, ``np.savez`` of the same leaves writes the port's archive byte
    for byte, also where sizes, offsets or the member count pass zipfile's
    zip64 limits (lowered here, for both writers, so small files pass
    them)."""
    import time

    epoch = time.struct_time((1980, 1, 1, 0, 0, 0, 1, 1, 0))
    monkeypatch.setattr(zipfile.time, "localtime", lambda *a: epoch)
    monkeypatch.setattr(zipfile, "ZIP64_LIMIT", zip64_limit)
    monkeypatch.setattr(zipfile, "ZIP_FILECOUNT_LIMIT", count_limit)
    monkeypatch.setattr(ckpt, "_ZIP64_LIMIT", zip64_limit)
    monkeypatch.setattr(ckpt, "_COUNT_LIMIT", count_limit)
    rng = np.random.default_rng(8)
    leaves = [rng.normal(size=60).astype(np.float32),
              np.asarray(3, np.int32), np.ones((7, 3), np.float32),
              np.zeros(0, np.float32)]
    np.savez(tmp_path / "ref.npz", **{f"a{i}": v
                                      for i, v in enumerate(leaves)})
    size, crc = ckpt._write_npz(
        str(tmp_path / "port.npz"),
        [torch.from_numpy(v) if v.ndim else int(v) for v in leaves])
    blob = (tmp_path / "port.npz").read_bytes()
    assert blob == (tmp_path / "ref.npz").read_bytes()
    assert (size, crc) == (len(blob), zlib.crc32(blob))


# ------------------------------------------- the format, across packages


SYNC = dict(compress_topk=0.2, quantize_int8=True, error_feedback=True,
            codec_block=128)


def _jloss(params, batch):
    pred = batch["x"] @ params["w"] + params["bias"]
    return jnp.mean((pred - batch["y"]) ** 2) + 0.01 * jnp.mean(
        params["embed"].astype(jnp.float32) ** 2), {}


def _jinit(key):
    kw, ke = jax.random.split(key)
    return {"w": jax.random.normal(kw, (8, 4)) * 0.1,
            "bias": jnp.zeros((4,)),
            "embed": (jax.random.normal(ke, (16, 4)) * 0.1).astype(
                jnp.bfloat16)}


def _tinit(gen):
    return {"w": torch.randn(8, 4, generator=gen) * 0.1,
            "bias": torch.zeros(4),
            "embed": (torch.randn(16, 4, generator=gen) * 0.1).to(
                torch.bfloat16)}


def _tloss(params, batch):
    pred = batch["x"] @ params["w"] + params["bias"]
    return torch.mean((pred - batch["y"]) ** 2) + 0.01 * torch.mean(
        params["embed"].float() ** 2), {}


def _jax_state(n_pods=2, steps=4):
    """A reference codec ``TrainState`` after a few steps and two rounds
    (bf16 embed leaf, non-zero EF residual and telemetry)."""
    tr = JTrainer(_jloss, _jinit, JTrainerConfig(
        n_pods=n_pods, optimizer="sgd", lr=0.05,
        sync=jsync.SyncConfig("asgd_ga", 2, **SYNC)))
    st = tr.init_state(jax.random.key(0))
    rng = np.random.default_rng(7)
    for step in range(steps):
        x = rng.normal(size=(n_pods, 16, 8)).astype(np.float32)
        y = (x[..., :4] * 0.5).astype(np.float32)
        st, _ = tr.train_step(st, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        st = tr.maybe_sync(st, step, model_mb=0.001)
    return st


def _port_like(n_pods=2):
    tr = Trainer(_tloss, _tinit, TrainerConfig(
        n_pods=n_pods, optimizer="sgd", lr=0.05,
        sync=SyncConfig("asgd_ga", 2, **SYNC)), device="cpu")
    return tr.init_state(0)


def _np(x):
    """A port leaf as the reference holds it: the ``int`` step as its 0-d
    int32, bf16 through ml_dtypes."""
    return np.asarray(x, np.int32) if isinstance(x, int) else (
        x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        if x.dtype == torch.bfloat16 else x.numpy())


def test_reference_train_state_restores_in_the_port(tmp_path):
    """A codec ``TrainState`` written by the reference restores into the
    port's ``TrainState`` bit for bit, bf16 params included, with the
    step as an ``int``; the port's keys are the reference's."""
    jst = _jax_state()
    jckpt.save(str(tmp_path), jst, step=4, metadata={"pods": 2})
    like = _port_like()
    keys, _, _ = jckpt._flatten_with_paths(jst)
    assert ckpt._keys(like) == keys == [
        ".params/bias", ".params/embed", ".params/w",
        ".sync_state/.ga_buffer/bias", ".sync_state/.ga_buffer/embed",
        ".sync_state/.ga_buffer/w", ".sync_state/.steps_since_sync",
        ".sync_state/.significant_frac", ".sync_state/.ef_residual",
        ".sync_state/.tier", ".sync_state/.msg_norm",
        ".sync_state/.resid_norm", ".step"]
    out, step = ckpt.restore(str(tmp_path), like)
    assert step == 4
    assert isinstance(out.step, int) and out.step == int(jst.step) == 4
    assert out.params["embed"].dtype == torch.bfloat16
    for want, got in zip(jax.tree.leaves(jst), T.leaves(out), strict=True):
        np.testing.assert_array_equal(_np(got), np.asarray(want),
                                      strict=True)


def test_port_train_state_restores_in_the_reference(tmp_path):
    """The other way: the port writes, the reference restores into its own
    ``TrainState`` bit for bit; the two packages write the same manifest
    (keys, dtypes, shapes, step, metadata)."""
    jst = _jax_state()
    like = _port_like()
    ckpt_dir = tmp_path / "ref"
    jckpt.save(str(ckpt_dir), jst, step=4, metadata={"pods": 2})
    tst, _ = ckpt.restore(str(ckpt_dir), like)
    ckpt.save(str(tmp_path / "port"), tst, step=4, metadata={"pods": 2})
    back, step = jckpt.restore(str(tmp_path / "port"),
                               jax.tree.map(jnp.zeros_like, jst))
    assert step == 4
    for want, got in zip(jax.tree.leaves(jst), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      strict=True)
    mj = jckpt.load_manifest(str(ckpt_dir))
    mt = ckpt.load_manifest(str(tmp_path / "port"))
    for k in ("step", "keys", "dtypes", "shapes", "metadata"):
        assert mt[k] == mj[k], k


def test_params_cross_restore_with_pod_resize(tmp_path):
    """A parameter tree written by the reference at 2 pods restores in the
    port at 3 (``pod_resize="mean"``), and the port's at 2 in the
    reference at 3: both equal the reference's own grown restore, bit for
    bit; the port restores the port's file the same way."""
    params = _jax_state().params
    jckpt.save(str(tmp_path / "ref"), params, step=4)
    jlike3 = jax.tree.map(lambda x: jnp.zeros((3,) + x.shape[1:], x.dtype),
                          params)
    want, _ = jckpt.restore(str(tmp_path / "ref"), jlike3,
                            pod_resize="mean")
    tlike3 = T.tree_map(lambda x: torch.zeros((3,) + tuple(x.shape[1:]),
                                              dtype=x.dtype),
                        _port_like().params)
    got, _ = ckpt.restore(str(tmp_path / "ref"), tlike3, pod_resize="mean")
    tparams, _ = ckpt.restore(str(tmp_path / "ref"), _port_like().params)
    ckpt.save(str(tmp_path / "port"), tparams, step=4)
    back, _ = jckpt.restore(str(tmp_path / "port"), jlike3,
                            pod_resize="mean")
    again, _ = ckpt.restore(str(tmp_path / "port"), tlike3,
                            pod_resize="mean")
    for w, g, b, a in zip(jax.tree.leaves(want), T.leaves(got),
                          jax.tree.leaves(back), T.leaves(again),
                          strict=True):
        for x in (_np(g), np.asarray(b), _np(a)):
            np.testing.assert_array_equal(x, np.asarray(w), strict=True)
    assert got["embed"].dtype == torch.bfloat16


def _drive(tr, st, n_steps, n_pods, seed=3):
    rng = np.random.default_rng(seed)
    for step in range(n_steps):
        x = rng.normal(size=(n_pods, 16, 8)).astype(np.float32)
        y = (x[..., :4] * 0.5).astype(np.float32)
        st, _ = tr.train_step(st, {"x": torch.from_numpy(x),
                                   "y": torch.from_numpy(y)})
        st = tr.maybe_sync(st, step, model_mb=0.001)
    return st


def test_restore_into_different_topology(tmp_path):
    """Params trained and checkpointed by the reference under a flat 2-pod
    ring restore in the port into a 3-pod run aggregating through a
    hierarchical (2-region tree) transport: ``pod_resize`` grows the
    stack as the reference's own restore does, bit for bit, the
    transport ships it, and training goes on from the restored values."""
    from repro_torch.core.topology import HierarchicalTransport, TopologySpec
    from repro_torch.core.wan import BandwidthTrace, WANConfig

    params = _jax_state().params
    jckpt.save(str(tmp_path), params, step=4,
               metadata={"pods": 2, "topology": "ring"})
    hier = HierarchicalTransport(
        TopologySpec.from_regions(["sh", "sh", "cq"], kind="tree"),
        BandwidthTrace((0.0,), (100.0,)), wan=WANConfig(seed=0))
    tr3 = Trainer(_tloss, _tinit, TrainerConfig(
        n_pods=3, optimizer="sgd", lr=0.05,
        sync=SyncConfig("asgd_ga", 2, **SYNC)), device="cpu",
        transport=hier)
    st3 = tr3.init_state(1)
    restored, step = ckpt.restore(str(tmp_path), st3.params,
                                  pod_resize="mean")
    assert step == 4
    old = np.asarray(params["w"], np.float32)
    new = restored["w"].numpy()
    assert new.shape[0] == 3
    np.testing.assert_array_equal(new[:2], old)
    np.testing.assert_allclose(new.mean(axis=0), old.mean(axis=0),
                               rtol=1e-5, atol=1e-6)
    want, _ = jckpt.restore(str(tmp_path), jax.tree.map(
        lambda x: jnp.zeros((3,) + x.shape[1:], x.dtype), params),
        pod_resize="mean")
    for w, g in zip(jax.tree.leaves(want), T.leaves(restored), strict=True):
        np.testing.assert_array_equal(_np(g), np.asarray(w), strict=True)
    st3 = _drive(tr3, st3._replace(params=restored), 4, 3)
    assert bool(torch.isfinite(st3.params["w"]).all())
    assert len(hier.records) > 0
    assert hier.wan_transfers_per_round == 2


def test_restore_same_values_across_topologies(tmp_path):
    """A checkpoint is topology-agnostic: restoring one file under a flat
    and a hierarchical trainer's parameter stacks (``pod_resize`` at the
    same size) gives bit-identical stacks, the reference's restore of the
    same file among them."""
    from repro_torch.core.topology import HierarchicalTransport, TopologySpec
    from repro_torch.core.wan import BandwidthTrace, WANConfig

    cfg = TrainerConfig(n_pods=3, optimizer="sgd", lr=0.05,
                        sync=SyncConfig("asgd_ga", 2, **SYNC))
    tr = Trainer(_tloss, _tinit, cfg, device="cpu")
    st = _drive(tr, tr.init_state(0), 4, 3)
    ckpt.save(str(tmp_path), st.params, step=4)
    hier = Trainer(_tloss, _tinit, cfg, device="cpu",
                   transport=HierarchicalTransport(
                       TopologySpec.from_regions(["sh", "sh", "cq"]),
                       BandwidthTrace((0.0,), (100.0,)),
                       wan=WANConfig(seed=0)))
    flat, _ = ckpt.restore(str(tmp_path), _zeros(st.params))
    grown, _ = ckpt.restore(str(tmp_path), hier.init_state(1).params,
                            pod_resize="mean")
    ref, _ = jckpt.restore(str(tmp_path), jax.tree.map(
        lambda x: jnp.zeros(x.shape, jnp.bfloat16 if x.dtype ==
                            torch.bfloat16 else jnp.float32),
        st.params), pod_resize="mean")
    for a, b, r in zip(T.leaves(flat), T.leaves(grown), jax.tree.leaves(ref),
                       strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
        np.testing.assert_array_equal(_np(a), np.asarray(r), strict=True)


# --------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_restore_onto_the_card(cuda, tmp_path):
    """A CPU-written state restores onto the card (``device="cuda"``),
    bit for bit, bf16 included."""
    like = _port_like()
    ckpt.save(str(tmp_path), like, step=2)
    out, step = ckpt.restore(str(tmp_path), like, device=cuda)
    assert step == 2 and out.step == like.step
    for a, b in zip(T.leaves(like), T.leaves(out), strict=True):
        if isinstance(a, int):
            assert a == b
            continue
        assert b.device.type == "cuda" and b.dtype == a.dtype
        assert torch.equal(a, b.cpu())
    ckpt.save(str(tmp_path / "again"), out, step=2)
    back, _ = ckpt.restore(str(tmp_path / "again"), like)
    _equal(like, back)
