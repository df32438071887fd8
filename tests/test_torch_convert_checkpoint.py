"""Checkpoints the JAX package trained, read by the port without JAX: the
reader of flax's msgpack format (``utils/flax_msgpack.py``), the
``convert_checkpoint`` CLI and the stage CLIs given a JAX checkpoint
directory, against the JAX package on the CPU.

The directories are real ``save_checkpoint`` outputs of the JAX package at
resnet18 and 32^2 images, their weights and BatchNorm statistics drawn with
numpy from a seed: a pretrain state (SGD-Nesterov, Lookahead's slow weights,
a 6-way Classifier), a Kather fine-tune state (Adam, a 9-way FinetuneHead), a
serving state (a 2-way FinetuneHead), a headless one without meta.json, and
the headless one written in flax's chunked form.  The reader is held to
``flax.serialization.msgpack_restore`` bit for bit, the CLI to the JAX CLI
bit for bit, the converted weights' eval logits to the JAX model's within
1e-4 (float32, the tolerance of tests/test_torch_eval.py), and each stage
CLI from a directory to the same CLI from the directory's converted .pth
bit for bit.  chip_smoke.py's writer of JAX checkpoints (phase 18, where
the card's machine has no flax) is held to flax's own bytes and the JAX
package's restore.
"""

import contextlib
import io
import os

import flax.serialization
import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from ssl_cr_histo_tpu.cli import convert_checkpoint as JC
from ssl_cr_histo_tpu.models import Classifier as JClassifier
from ssl_cr_histo_tpu.models import FinetuneHead as JFinetuneHead
from ssl_cr_histo_tpu.models import TripletNet as JTripletNet
from ssl_cr_histo_tpu.train import optim as joptim
from ssl_cr_histo_tpu.train.checkpoint import restore_checkpoint as j_restore
from ssl_cr_histo_tpu.train.checkpoint import save_checkpoint as j_save
from ssl_cr_histo_tpu.train.state import TrainState as JTrainState
from ssl_cr_histo_tpu_torch.cli import common as TC
from ssl_cr_histo_tpu_torch.cli import consistency, finetune
from ssl_cr_histo_tpu_torch.cli import convert_checkpoint as PC
from ssl_cr_histo_tpu_torch.cli import heatmap as heatmap_cli
from ssl_cr_histo_tpu_torch.models import Classifier, FinetuneHead, TripletNet, feature_dim
from ssl_cr_histo_tpu_torch.tools import parity_run
from ssl_cr_histo_tpu_torch.train.checkpoint import jax_to_reference, read_jax_checkpoint
from ssl_cr_histo_tpu_torch.utils import flax_msgpack as F
from torch_tmp import release, tmp_path  # noqa: F401  (a fixture)

IMG = 32
HEADS = {"pretrain": (JClassifier, 6), "finetune": (JFinetuneHead, 9), "serving": (JFinetuneHead, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the file's torch work (restored after): at
    these sizes more threads buy nothing, and under the six-worker run they
    contend with the other workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drawn(tree, rng):
    """Every leaf scaled by U(0.5, 1.5), and the vectors but BatchNorm
    variances moved by N(0, 0.05): no leaf keeps flax's initial 0 or 1, so
    a swapped or dropped tensor shows, and the logits stay of order 1."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _drawn(v, rng)
        else:
            v = np.asarray(v) * rng.uniform(0.5, 1.5, np.shape(v))
            moved = v.ndim == 1 and k != "var"
            out[k] = (v + 0.05 * rng.standard_normal(v.shape) if moved else v).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    """{name: checkpoint directory} written by the JAX package's
    save_checkpoint, and {name: its TrainState}."""
    root = tmp_path_factory.mktemp("jax_checkpoints")
    jm = JTripletNet("resnet18")
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, IMG, IMG, 3)), train=False, method=jm.encode_single))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    dirs, states = {}, {}
    for i, (name, (head, n)) in enumerate(HEADS.items()):
        model, stats = _drawn(jax.device_get(v["params"]), rng), _drawn(jax.device_get(v["batch_stats"]), rng)
        hp = head(num_classes=n).init(jax.random.PRNGKey(i + 1), jnp.zeros((1, 768)))["params"]
        params = {"model": model, "head": _drawn(jax.device_get(hp), rng)}
        tx = joptim.sgd_nesterov(0.01) if name == "pretrain" else joptim.adam(1e-4)
        states[name] = JTrainState(
            params=params, batch_stats=stats, opt_state=tx.init(params), step=jnp.asarray(7 + i, jnp.int32),
            slow_params=_drawn(params, rng) if name == "pretrain" else None,
            la_count=jnp.asarray(3, jnp.int32) if name == "pretrain" else None)
    states["headless"] = JTrainState(params={"model": states["serving"].params["model"]},
                                     batch_stats=states["serving"].batch_stats, opt_state=(),
                                     step=jnp.zeros([], jnp.int32))
    for name, state in states.items():
        dirs[name] = str(root / name)
        j_save(dirs[name], state, {"epoch": 4, "best_val": 0.25})
    os.remove(os.path.join(dirs["headless"], "meta.json"))
    with pytest.MonkeyPatch.context() as mp:  # flax's chunked leaves, at 64 KiB a chunk
        mp.setattr(flax.serialization, "MAX_CHUNK_SIZE", 1 << 16)
        dirs["chunked"] = str(root / "chunked")
        j_save(dirs["chunked"], states["headless"], {"epoch": 2})
    yield dirs, states
    release(root)


def _same_tree(got, want, where=""):
    """The reader's tree equals flax's: the same dicts and lists, each array
    of the same dtype, shape and bytes (bfloat16: a torch tensor of the same
    bits), each scalar of the same type and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{where}[{i}]")
    elif isinstance(got, torch.Tensor):
        w = np.asarray(want)
        assert got.dtype == torch.bfloat16 and w.dtype.name == "bfloat16" and tuple(got.shape) == w.shape, where
        assert got.view(torch.int16).numpy().tobytes() == w.tobytes(), where
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def _sorted(tree):
    """A tree's dicts with their keys in order, as flax writes them."""
    return {k: _sorted(v) for k, v in sorted(tree.items())} if isinstance(tree, dict) else tree


def _bytes(path):
    with open(os.path.join(path, "checkpoint.msgpack"), "rb") as f:
        return f.read()


# --- the reader -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["pretrain", "finetune", "serving", "headless", "chunked"])
def test_reader_matches_flax_msgpack_restore(jax_dirs, name):
    """Each JAX checkpoint read without flax is flax's msgpack_restore of
    it, leaf for leaf (the nil slow_params and la_count of the Adam states,
    optax's '0'/'1' dicts, the chunked leaves joined); the leaves are views
    of the bytes read, not copies."""
    dirs, _ = jax_dirs
    data = _bytes(dirs[name])
    assert (b"__msgpack_chunked_array__" in data) == (name == "chunked")
    got = F.read(os.path.join(dirs[name], "checkpoint.msgpack"))
    _same_tree(got, flax.serialization.msgpack_restore(data))
    kernel = got["params"]["model"]["backbone"]["layer4_1"]["conv2"]["kernel"]  # 9 MiB: chunked in "chunked"
    assert kernel.flags.writeable == (name == "chunked")  # np.concatenate copies the chunks, as flax does
    if name != "pretrain":
        assert got.get("slow_params", None) is None


def _leaf_kinds():
    """Every kind of leaf flax writes: arrays of numpy's dtypes, bfloat16
    arrays and scalars, numpy scalars, a Python complex, nil, bools, ints of
    each msgpack width, floats, str, bytes, lists, empty maps and arrays."""
    rng = np.random.default_rng(3)
    ints = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128, -129,
            -2**15, -2**15 - 1, -2**31, -2**31 - 1, -2**63]
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "dtypes": {str(d): rng.integers(0, 100, (4, 2)).astype(d) for d in
                   (np.float16, np.float64, np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint32, np.bool_,
                    np.complex64)},
        "bf16": jnp.asarray(rng.standard_normal((8, 8)), jnp.bfloat16),
        "bf16_scalar": jnp.bfloat16(1.5),
        "scalars": [np.float32(2.5), np.int32(-3), np.int64(2**40), np.bool_(True), np.float64(-0.125)],
        "complex": 1.5 - 2j, "nil": None, "flags": [True, False], "ints": ints, "float": 0.1,
        "str": ["", "a" * 31, "b" * 32, "é" * 200, "c" * 70000], "bytes": [b"", b"\x00" * 300, b"\x01" * 70000],
        "empty": {}, "empty_array": np.zeros((0, 3), np.float32), "zero_d": np.array(7, np.int32),
        "wide": {str(k): k for k in range(20)}, "long": list(range(70000)),
    }


@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunked"])
def test_reader_matches_flax_on_every_leaf_kind(chunk, monkeypatch):
    """flax's msgpack_serialize of every kind of leaf, whole and with
    MAX_CHUNK_SIZE at 64 bytes (the float32, bfloat16 and string-free
    arrays above it chunked), reads back as flax reads it."""
    if chunk:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
    data = flax.serialization.msgpack_serialize(_leaf_kinds())
    assert (b"__msgpack_chunked_array__" in data) == bool(chunk)
    got = F.restore(data)
    _same_tree(got, flax.serialization.msgpack_restore(data))
    assert got["bf16"].dtype == torch.bfloat16 and got["bf16_scalar"].dim() == 0


def test_reader_matches_msgpack_on_float32_and_raw_strings():
    """The forms flax's own writer does not use but msgpack's does: float32
    (``use_single_float``) and str written as raw bytes, as an ndarray
    payload of an old writer has them."""
    obj = {"single": [1.5, -0.1, 3e38], "wide": {str(k): [k, float(k)] for k in range(20)}}
    data = msgpack.packb(obj, use_single_float=True)
    _same_tree(F.restore(data), msgpack.unpackb(data, raw=False))
    arr = np.arange(6, dtype=np.int16).reshape(2, 3)
    old = msgpack.packb(msgpack.ExtType(1, msgpack.packb([[2, 3], "int16", arr.tobytes()], use_bin_type=False)))
    np.testing.assert_array_equal(F.restore(old), arr)


@pytest.mark.parametrize("data, message", [
    (msgpack.packb(msgpack.ExtType(5, b"abc")), "ext type 5"),
    (msgpack.packb(msgpack.ExtType(1, msgpack.packb([[1], "float8_zz", b"a"]))), "'float8_zz'"),
    (msgpack.packb({"a": b"x" * 10})[:-3], "truncated"),
    (msgpack.packb([1, 2]) + b"\x00", "1 bytes after"),
    (b"\xc1", "starts no msgpack object"),
], ids=["ext", "dtype", "truncated", "trailing", "never_used"])
def test_reader_refuses_what_flax_does_not_write(data, message):
    with pytest.raises(ValueError, match=message):
        F.restore(data)


def test_read_jax_checkpoint_needs_checkpoint_msgpack(tmp_path):
    """A directory without checkpoint.msgpack raises, naming it; meta.json
    absent reads as {}."""
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        read_jax_checkpoint(str(tmp_path))


# --- the convert_checkpoint CLI ---------------------------------------------------


def _same(a, b, where=""):
    """Bit-equality of two checkpoint dicts: keys, tensors' dtypes, shapes
    and values, and plain values."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    else:
        assert a == b, (where, a, b)


@pytest.fixture(scope="module")
def converted(jax_dirs, tmp_path_factory):
    """{name: (the JAX CLI's .pt, the port CLI's .pt, each CLI's line)} for
    the pretrain, fine-tune, serving and headless directories."""
    dirs, _ = jax_dirs
    root = tmp_path_factory.mktemp("converted")
    out = {}
    for name in ("pretrain", "finetune", "serving", "headless"):
        lines = []
        for cli, side in ((JC, "jax"), (PC, "port")):
            path = str(root / f"{name}_{side}.pt")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(["--input", dirs[name], "--output", path])
            lines.append(buf.getvalue().replace(path, "OUT"))
        out[name] = (str(root / f"{name}_jax.pt"), str(root / f"{name}_port.pt"), lines)
    yield out
    release(root)


@pytest.mark.parametrize("name", ["pretrain", "finetune", "headless"])
def test_convert_cli_matches_the_jax_cli(converted, name):
    """The port's CLI writes the JAX CLI's .pt bit for bit (keys, dtypes,
    shapes, values, num_batches_tracked 0-d int64 0, the epoch) and prints
    its line; the result loads strictly into the port's TripletNet and head
    (none for the headless directory, whose missing meta.json gives epoch
    0)."""
    jax_pt, port_pt, lines = converted[name]
    want, got = (torch.load(p, weights_only=False) for p in (jax_pt, port_pt))
    _same(got, want)
    assert lines[0] == lines[1]
    assert got["epoch"] == (0 if name == "headless" else 4)
    nbt = got["model"]["model.bn1.num_batches_tracked"]
    assert nbt.dtype == torch.int64 and nbt.dim() == 0 and int(nbt) == 0
    TripletNet("resnet18").load_state_dict(got["model"])
    if name == "headless":
        assert "classifier" not in got
    else:
        head = Classifier if name == "pretrain" else FinetuneHead
        head(feature_dim("resnet18"), HEADS[name][1]).load_state_dict(got["classifier"])


@pytest.mark.parametrize("name", ["pretrain", "finetune"])
def test_converted_logits_match_jax(jax_dirs, converted, name):
    """Eval-mode logits of the converted .pt in the port (the triplet
    forward and the Classifier; encode_single and the FinetuneHead) against
    the JAX package's model.apply on the checkpoint's params, on seeded
    inputs: within 1e-4."""
    dirs, _ = jax_dirs
    tree = flax.serialization.msgpack_restore(_bytes(dirs[name]))
    variables = {"params": tree["params"]["model"], "batch_stats": tree["batch_stats"]}
    head_cls, n = HEADS[name]
    jm, jh = JTripletNet("resnet18"), head_cls(num_classes=n)
    raw = torch.load(converted[name][1], weights_only=False)
    model, head = TripletNet("resnet18"), (Classifier if name == "pretrain" else FinetuneHead)(768, n)
    model.load_state_dict(raw["model"])
    head.load_state_dict(raw["classifier"])
    model.eval()
    head.eval()
    x = np.random.default_rng(11).standard_normal((3, 2, IMG, IMG, 3)).astype(np.float32)
    with torch.no_grad():
        if name == "pretrain":
            views = [torch.from_numpy(v.transpose(0, 3, 1, 2).copy()) for v in x]
            got = head(model(*views)).numpy()
            feats = jax.jit(lambda a, b, c: jm.apply(variables, a, b, c, train=False))(*x)
        else:
            got = head(model.encode_single(torch.from_numpy(x[0].transpose(0, 3, 1, 2).copy()))).numpy()
            feats = jax.jit(lambda a: jm.apply(variables, a, train=False, method=jm.encode_single))(x[0])
    want = jh.apply({"params": tree["params"]["head"]}, feats)
    assert got.shape == want.shape == (2, n)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


# --- the stage CLIs from a JAX directory -------------------------------------------


@pytest.fixture(scope="module")
def kather(tmp_path_factory):
    """Three Kather class folders of six 32^2 PNGs."""
    import cv2

    root = tmp_path_factory.mktemp("convert_kather")
    rng = np.random.default_rng(0)
    for c, cls in enumerate(("ADI", "LYM", "TUM")):
        os.makedirs(root / cls)
        for i in range(6):
            img = np.clip(30 + 70 * c + rng.integers(0, 40, (IMG, IMG, 3)), 0, 255).astype(np.uint8)
            cv2.imwrite(str(root / cls / f"p{i}.png"), img)
    yield str(root)
    release(root)


def _final(save_dir):
    """final.pth without the meta's record of the command line."""
    raw = torch.load(os.path.join(save_dir, "final.pth"), weights_only=False)
    raw["meta"].pop("args", None)
    return raw


def test_finetune_cli_from_a_jax_directory_equals_its_pth(jax_dirs, converted, kather, tmp_path, capsys):
    """--model_path the pretrain directory, one epoch: final.pth bit-equal
    to the run from the directory's converted .pt (weights, Adam's moments,
    the schedule, the step, the generator, the best value)."""
    dirs, _ = jax_dirs
    for ckpt, save in ((dirs["pretrain"], "dir"), (converted["pretrain"][1], "pth")):
        finetune.main(["--task", "kather", "--train_path", kather, "--model_path", ckpt, "--save_dir",
                       str(tmp_path / save), "--device", "cpu", "--image_size", str(IMG), "--batch_size", "4",
                       "--num_epoch", "1", "--lr", "1e-3", "--validation_split", "0.25", "--no-bf16"])
    assert f"loaded pretrained backbone from {dirs['pretrain']}" in capsys.readouterr().out
    _same(_final(tmp_path / "dir"), _final(tmp_path / "pth"))


def test_consistency_cli_from_a_jax_directory_equals_its_pth(jax_dirs, converted, kather, tmp_path):
    """--finetune_ckpt the Kather fine-tune directory (9-way head), one
    epoch: final.pth bit-equal to the run from its converted .pt."""
    dirs, _ = jax_dirs
    for ckpt, save in ((dirs["finetune"], "dir"), (converted["finetune"][1], "pth")):
        consistency.main(["--task", "kather", "--train_path", kather, "--finetune_ckpt", ckpt, "--save_dir",
                          str(tmp_path / save), "--device", "cpu", "--image_size", str(IMG), "--batch_size", "2",
                          "--mu", "2", "--NAug", "2", "--labeled_train", "0.5", "--modules_student", "45",
                          "--lr", "1e-3", "--num_epoch", "1", "--validation_split", "0.25", "--no-bf16"])
    _same(_final(tmp_path / "dir"), _final(tmp_path / "pth"))


def test_heatmap_cli_from_a_jax_directory_equals_its_pth(jax_dirs, converted, tmp_path):
    """--finetune_ckpt the serving directory (2-way head): each map equal
    to the map from its converted .pt."""
    dirs, _ = jax_dirs
    rng = np.random.default_rng(5)
    wsis, masks = tmp_path / "wsis", tmp_path / "masks"
    for d in (wsis, masks):
        os.makedirs(d)
    for name in ("tumor_001", "normal_001"):
        slide = np.full((256, 256, 3), 245, np.uint8)
        slide[:, :160] = np.clip(np.array([190, 80, 160]) + rng.integers(-40, 40, (256, 160, 3)), 0, 255)
        np.save(wsis / f"{name}.npy", slide)
        np.save(masks / f"{name}_tissue.npy", (rng.random((8, 8)) < 0.5).astype(np.uint8))
    maps = [heatmap_cli.main(["--test_image_pth", str(wsis), "--test_mask_pth", str(masks), "--probs_map_path",
                              str(tmp_path / out), "--finetune_ckpt", ckpt, "--device", "cpu", "--no-bf16",
                              "--image_size", str(IMG), "--batch_size", "8"])
            for ckpt, out in ((dirs["serving"], "dir"), (converted["serving"][1], "pth"))]
    assert sorted(maps[0]) == sorted(maps[1]) == ["normal_001", "tumor_001"]
    for name in maps[0]:
        np.testing.assert_array_equal(maps[0][name], maps[1][name])
        assert maps[0][name].any()


def test_stage_clis_refuse_a_directory_without_a_checkpoint(kather, tmp_path):
    """A directory without checkpoint.msgpack given to --model_path or
    --finetune_ckpt raises, naming it."""
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    common = ["--task", "kather", "--train_path", kather, "--save_dir", str(tmp_path / "run"), "--device", "cpu",
              "--image_size", str(IMG), "--batch_size", "2", "--num_epoch", "1", "--validation_split", "0.25",
              "--no-bf16"]
    with pytest.raises(FileNotFoundError, match=f"{empty}: no checkpoint.msgpack"):
        finetune.main(common + ["--model_path", empty])
    with pytest.raises(FileNotFoundError, match=f"{empty}: no checkpoint.msgpack"):
        consistency.main(common + ["--finetune_ckpt", empty, "--mu", "2", "--labeled_train", "0.5"])


def test_resume_refuses_a_jax_directory(jax_dirs, kather, tmp_path):
    """--resume with a JAX directory raises, naming the optimizer state that
    does not carry over, and trains nothing."""
    dirs, _ = jax_dirs
    with pytest.raises(SystemExit, match="optimizer, Lookahead and schedule state do not carry over"):
        finetune.main(["--task", "kather", "--train_path", kather, "--save_dir", str(tmp_path), "--device", "cpu",
                       "--image_size", str(IMG), "--batch_size", "4", "--num_epoch", "1", "--no-bf16",
                       "--resume", dirs["finetune"]])
    assert not os.path.exists(tmp_path / "final.pth")
    args = type("A", (), {"resume": dirs["pretrain"], "save_dir": str(tmp_path)})
    with pytest.raises(SystemExit, match="--resume takes the port's own .pth"):
        TC.resume_training(args, None, None, {})


def test_parity_run_takes_a_jax_directory(jax_dirs, tmp_path, monkeypatch):
    """parity_run --pretrained a JAX directory reaches the protocol, which
    hands it to the fine-tune CLI's --model_path."""
    dirs, _ = jax_dirs
    seen = []

    def stop(args, *rest):
        seen.append(args.pretrained)
        raise SystemExit("stop")

    monkeypatch.setattr(parity_run, "run_fraction", stop)
    with pytest.raises(SystemExit, match="stop"):
        parity_run.main(["--task", "kather", "--pretrained", dirs["pretrain"], "--train_path", "t", "--test_path",
                         "t", "--out", str(tmp_path / "out.json"), "--workdir", str(tmp_path / "w")])
    assert seen == [dirs["pretrain"]]


# --- chip_smoke.py's writer (phase 18) ----------------------------------------------


@pytest.mark.parametrize("name", ["pretrain", "serving"])
def test_chip_smoke_writes_the_jax_packages_checkpoint(jax_dirs, converted, tmp_path, name):
    """chip_smoke.jax_tree of the converted .pt is the JAX checkpoint's
    params and batch_stats (paths, dtypes, shapes, bits); write_jax_checkpoint
    writes bytes flax's msgpack_serialize writes for the same state dict,
    which the JAX package's restore_checkpoint takes into a TrainState of
    the same optimizer (and Lookahead) with nothing missing, and which the
    port's reader and jax_to_reference carry back to the .pt."""
    dirs, states = jax_dirs
    raw = torch.load(converted[name][1], weights_only=False)
    want = flax.serialization.msgpack_restore(_bytes(dirs[name]))
    params, stats = chip_smoke.jax_tree(raw["model"], raw["classifier"])
    _same_tree(_sorted({"params": params, "batch_stats": stats}),
               _sorted({"params": want["params"], "batch_stats": want["batch_stats"]}))

    out = str(tmp_path / "ckpt")
    chip_smoke.write_jax_checkpoint(out, raw["model"], raw["classifier"], "sgd" if name == "pretrain" else "adam",
                                    4, 9)
    written = flax.serialization.msgpack_restore(_bytes(out))
    assert _bytes(out) == flax.serialization.msgpack_serialize(written)
    template = states[name]
    restored, meta = j_restore(out, template)
    assert meta == {"epoch": 4, "step": 9} and int(restored.step) == 9
    _same_tree(jax.device_get(restored.params), written["params"])
    # restore_checkpoint keeps the template's optimizer on a mismatch; from_state_dict raises on one
    flax.serialization.from_state_dict(template.opt_state, written["opt_state"])
    if name == "pretrain":
        flax.serialization.from_state_dict(template.slow_params, written["slow_params"])
        assert int(written["la_count"]) == 0
    else:
        assert written["slow_params"] is None and written["la_count"] is None
    _same(jax_to_reference(*read_jax_checkpoint(out)), {**raw, "epoch": 4})
