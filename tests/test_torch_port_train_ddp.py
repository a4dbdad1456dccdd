"""Data-parallel training in the port (training/train.py --mesh_data,
training/trainer.py's sharded step, dataset.batches(shard=),
parallel/mesh.py, parallel/launch.py) on the CPU: two gloo ranks as
spawned processes, the tiny models at 64^2, fp32, global batch 4.

- `train.main --mesh_data 2` for 3 steps, plain and with
  --gradient_accumulation_steps 2: the two ranks' trainables are bitwise
  equal (their sha256, all-gathered); the trainables match a
  `--mesh_data 1` run at the same global batch within the Watch list's
  training tolerance (rtol 1e-4, atol 1e-6, except at most 0.5% of the
  elements, each within lr / 2: Adam divides a near-zero gradient by its
  own root mean square, so its update's size does not follow its
  rounding), and so do each step's loss and grad_norm; rank 0 alone
  writes the checkpoints and the export; a resume from "latest" continues
  as the unbroken run, bit for bit.
- The ranks' batches, concatenated in rank order, are the unsharded
  batches, byte for byte.
- (At trainer level against JAX: tests/test_torch_port_train_ddp_jax.py.)
- The launcher stops every rank when one fails or the time runs out; the
  flags and layouts that cannot run raise SystemExit naming the cause.

Each spawned run has its own timeout (`main(..., timeout=)`,
`run_local_ranks(..., timeout=)`) and kills its ranks on failure. This
module imports no JAX: the ranks import it to find their functions.
"""

import os
import time

import numpy as np
import pytest
import torch

from diffusiontexturepainting_torch.parallel import launch
from diffusiontexturepainting_torch.parallel.mesh import plan_data_axis
from diffusiontexturepainting_torch.training import image_io, train
from diffusiontexturepainting_torch.training.dataset import AugmentedTextures

torch.set_num_threads(2)

RES, BATCH, STEPS, LR = 64, 4, 3, 1e-4
RTOL, ATOL = 1e-4, 1e-6
MAX_LOOSE_SHARE, STEP_ATOL_LR = 5e-3, 0.5
RUN_TIMEOUT = 300  # seconds a spawned run may take before its ranks die


@pytest.fixture(scope="module")
def textures(tmp_path_factory):
    """Six PNG and two JPEG textures."""
    from PIL import Image

    d = tmp_path_factory.mktemp("textures")
    for i in range(8):
        rng = np.random.default_rng(i)
        y, x = np.mgrid[0:96, 0:112]
        a = np.stack([128 + 90 * np.sin(x / (5.0 + i) + c)
                      * np.cos(y / (8.0 + i) - c) for c in range(3)], -1)
        a = np.clip(a + rng.integers(-20, 20, a.shape), 0,
                    255).astype(np.uint8)
        if i < 6:
            image_io.write_png(d / f"t{i}.png", a)
        else:
            Image.fromarray(a).save(d / f"t{i}.jpg", "JPEG", quality=90)
    return str(d)


def argv(textures, out, *extra, steps=STEPS):
    return ["--images_path", textures, "--output_dir", str(out),
            "--device", "cpu", "--tiny", "--resolution", str(RES),
            "--train_batch_size", str(BATCH), "--checkpointing_steps", "1",
            "--max_train_steps", str(steps), "--validation_epochs", "0",
            "--log_every", "1", "--learning_rate", str(LR), *extra]


def load_state(out, step):
    return torch.load(os.path.join(out, "checkpoints", str(step),
                                   train.CHECKPOINT_FILE),
                      map_location="cpu", weights_only=True)


OPTION_SETS = {"plain": (), "accum": ("--gradient_accumulation_steps", "2")}


@pytest.fixture(scope="module", params=list(OPTION_SETS))
def runs(request, textures, tmp_path_factory):
    """{name: (out dir, step records, report)} of one rank and of two
    ranks, both at global batch 4, under one option set."""
    extra = OPTION_SETS[request.param]
    out = {}
    for name, data in (("one", "1"), ("two", "2")):
        d = tmp_path_factory.mktemp(f"{request.param}_{name}")
        report = {}
        _, steps = train.main(argv(textures, d, "--mesh_data", data, *extra),
                              timeout=RUN_TIMEOUT, report=report)
        out[name] = (str(d), steps, report)
    out["option"] = request.param
    return out


def test_ranks_are_bitwise_equal(runs):
    _, _, report = runs["two"]
    ranks = report["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert {(r["world"], r["backend"], r["device"]) for r in ranks} == {
        (2, "gloo", "cpu")}
    digests = {tuple(r["digests"]) for r in ranks}
    assert len(digests) == 1
    (pair,) = digests
    assert len(pair) == 2 and pair[0] == pair[1]
    assert all(not r["launches"] for r in ranks)


def test_two_ranks_match_one(runs):
    """Each step's loss and grad_norm, and the trainables and Adam state
    after the last step, against the one-rank run."""
    one, two = runs["one"], runs["two"]
    for a, b in zip(one[1], two[1]):
        assert a["step"] == b["step"]
        np.testing.assert_allclose([b["loss"], b["grad_norm"]],
                                   [a["loss"], a["grad_norm"]], rtol=RTOL,
                                   atol=ATOL)
    want, got = load_state(one[0], STEPS), load_state(two[0], STEPS)
    assert got["step"] == want["step"] == STEPS
    loose = total = 0
    for k, w in want["params"].items():
        diff = (got["params"][k] - w).abs()
        loose += int((diff > ATOL + RTOL * w.abs()).sum())
        total += w.numel()
        assert float(diff.max()) <= STEP_ATOL_LR * LR, (k, float(diff.max()))
    assert loose <= MAX_LOOSE_SHARE * total, (loose, total)
    assert got["optimizer"]["count"] == want["optimizer"]["count"]
    if runs["option"] == "accum":
        assert got["optimizer"]["mini_step"] == want["optimizer"][
            "mini_step"] == STEPS % 2


def test_rank_zero_alone_writes(runs):
    d, _, report = runs["two"]
    ranks = report["ranks"]
    assert ranks[0]["checkpoints"] == list(range(1, STEPS + 1))
    assert ranks[1]["checkpoints"] == []
    assert [r["exported"] for r in ranks] == [True, False]
    assert sorted(os.listdir(os.path.join(d, "checkpoints"))) == [
        str(s) for s in range(1, STEPS + 1)]
    assert sorted(os.listdir(os.path.join(d, "export"))) == sorted(
        f"{n}.npz" for n in ("unet", "vae_encoder", "vae_decoder",
                             "patch_encoder"))
    assert [x for x in os.listdir(d) if x.startswith("export")] == [
        "export"]


def test_resume_continues_as_the_unbroken_run(runs, textures,
                                              tmp_path_factory):
    """Two ranks for 2 steps, then two ranks resumed from "latest" to
    step 3: the state equals the unbroken two-rank run's bit for bit."""
    extra = OPTION_SETS[runs["option"]]
    d = tmp_path_factory.mktemp(f"{runs['option']}_broken")
    _, first = train.main(argv(textures, d, "--mesh_data", "2", *extra,
                               steps=2), timeout=RUN_TIMEOUT)
    _, second = train.main(argv(textures, d, "--mesh_data", "2",
                                "--resume_from_checkpoint", "latest",
                                *extra), timeout=RUN_TIMEOUT)
    assert [h["step"] for h in first + second] == [1, 2, 3]
    whole = runs["two"]
    for a, b in zip(first + second, whole[1]):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
    a, b = load_state(str(d), STEPS), load_state(whole[0], STEPS)
    for k in b["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for k, v in b["optimizer"].items():
        if isinstance(v, dict):
            for n in v:
                assert torch.equal(a["optimizer"][k][n], v[n]), (k, n)
        else:
            assert a["optimizer"][k] == v, k


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_batches_concatenate_to_the_batch(textures, world):
    ds = AugmentedTextures(textures, size=32, cond_size=32, seed=4)
    whole = list(ds.batches(BATCH, steps=3, start=1))
    shards = [list(ds.batches(BATCH, steps=3, start=1, shard=(r, world)))
              for r in range(world)]
    for b, batch in enumerate(whole):
        for k, v in batch.items():
            got = np.concatenate([s[b][k] for s in shards])
            assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), \
                (b, k)
    with pytest.raises(ValueError, match="does not divide"):
        next(ds.batches(BATCH, shard=(0, 3)))


# --- the launcher and the refusals ---


def _fail_or_sleep(i, seconds):
    if i == 0:
        raise RuntimeError("rank 0 gives up")
    time.sleep(seconds)
    return i


def _sleep(seconds):
    time.sleep(seconds)


def test_launcher_stops_every_rank_when_one_fails():
    tic = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 0 failed.*gives up"):
        launch.run_local_ranks(_fail_or_sleep, [(0, 300), (1, 300)],
                               timeout=120)
    assert time.monotonic() - tic < 100
    assert launch.run_local_ranks(_fail_or_sleep, [(1, 0), (2, 0)],
                                  timeout=120) == [1, 2]


def test_launcher_timeout_kills_the_ranks():
    tic = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        launch.run_local_ranks(_sleep, [(300,), (300,)], timeout=8)
    assert time.monotonic() - tic < 60


@pytest.mark.parametrize("flags, match", [
    (("--mesh_model", "0"), "--mesh_model 0: a model axis of 0 ranks"),
    (("--mesh_data", "3"), "global batch: 3 data ranks must divide it"),
    (("--mesh_data", "3", "--num_processes", "2", "--coordinator",
      "127.0.0.1:1"), "do not divide over 2 processes"),
    (("--num_processes", "2", "--mesh_data", "2"), "needs --coordinator"),
    (("--process_id", "2", "--num_processes", "2", "--coordinator",
      "127.0.0.1:1", "--mesh_data", "2"), "process id 2 of 2"),
])
def test_refusals_name_the_cause(textures, tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        train.main(argv(textures, tmp_path, *flags), timeout=RUN_TIMEOUT)
    assert not os.path.exists(tmp_path / "checkpoints")


def test_data_axis_layouts():
    """Ranks on cards: NCCL needs a card each, gloo lets them share; the
    default axis is every card of every process; the CPU is gloo."""
    axis = plan_data_axis(None, 2, 1, "cuda", 8)
    assert (axis.world, axis.local, axis.backend) == (16, 8, "nccl")
    assert axis.rank(3).rank == 11
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        plan_data_axis(2, None, None, "cuda", 1)
    shared = plan_data_axis(2, None, None, "cuda", 1, backend="gloo")
    assert (shared.world, shared.local, shared.backend) == (2, 2, "gloo")
    assert plan_data_axis(None, None, None, "cpu", 1).world == 1
    assert plan_data_axis(None, None, None, "cpu", 1).backend is None
    assert plan_data_axis(2, None, None, "cpu", 1).backend == "gloo"
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        plan_data_axis(2, None, None, "cpu", 1, backend="nccl")
    with pytest.raises(ValueError, match="no cuda device"):
        plan_data_axis(None, None, None, "cuda", 0)
