"""Model-parallel training in the port (training/train.py --mesh_model,
parallel/mesh.py ModelShards and mesh_groups, training/trainer.py) on the
CPU: gloo ranks as spawned processes, the tiny models at 64^2, fp32.

- The sharding rule at full SD-1.5 width: every frozen leaf of the UNet,
  the VAE encoder and CLIP, the port's modules built on the meta device
  and the JAX ones through jax.eval_shape: the port shards a leaf exactly
  where the JAX param_spec shards the JAX leaf, at M = 2 and 4, and the
  JAX leaf's shape is the one the port reads (a Dense kernel transposed).
- `train.main --mesh_data 1 --mesh_model 2` (two ranks) against
  `--mesh_data 1` (one rank, one torch thread as each spawned rank has):
  every step's loss and grad_norm, the trainables and the export bitwise
  equal; a rank holds half the frozen bytes of the whole towers or less.
- `--mesh_data 2 --mesh_model 2` (four ranks) against `--mesh_data 2`:
  the same, bitwise.
- At trainer level, four ranks under (data 2, model 2) against the JAX
  make_train_step under make_mesh(data=2, model=2) with its frozen towers
  placed by shard_params, on four of the conftest's host devices: each
  micro-step's loss and grad_norm and the trainables after four
  micro-steps within tests/test_torch_port_training.py's tolerance (its
  assert_trainables_close), the ranks bitwise equal.
- The layouts and refusals of the (data, model) mesh.

Each spawned run has its own timeout and kills its ranks on failure.
"""

import os

import numpy as np
import pytest
import torch

from diffusiontexturepainting_torch.parallel import launch
from diffusiontexturepainting_torch.parallel.mesh import (
    DataRank,
    jax_leaf_shapes,
    param_spec_dim,
    plan_data_axis,
    shard_dims,
)
from diffusiontexturepainting_torch.training import image_io, train

torch.set_num_threads(2)

RES, BATCH, STEPS, LR = 64, 4, 3, 1e-4
RUN_TIMEOUT = 300  # seconds a spawned run may take before its ranks die


# --- the sharding rule at full width ---


def _jax_shapes(component):
    """{JAX path: leaf shape} of a full SD-1.5 component, from shapes
    only."""
    import jax
    import jax.numpy as jnp

    from diffusiontexturepainting_tpu.core import config as j_config
    from diffusiontexturepainting_tpu.models import patch_encoder as j_pe
    from diffusiontexturepainting_tpu.models import unet as j_unet
    from diffusiontexturepainting_tpu.models import vae as j_vae

    key = jax.random.PRNGKey(0)
    if component == "unet":
        m = j_unet.UNet2DCondition(j_config.UNetConfig())
        tree = jax.eval_shape(m.init, key, jnp.zeros((1, 8, 8, 9)),
                              jnp.float32(0.0), jnp.zeros((1, 14, 768)))
    elif component == "vae_encoder":
        m = j_vae.VAEEncoder(j_config.VAEConfig())
        tree = jax.eval_shape(m.init, key, jnp.zeros((1, 64, 64, 3)))
    else:
        pcfg = j_config.PatchEncoderConfig()
        m = j_pe.ConditionPatchEncoder(pcfg)
        cs = pcfg.clip.image_size
        tree = jax.eval_shape(
            lambda k, x: m.init(k, x, return_uncond_vector=True), key,
            jnp.zeros((1, pcfg.total_patches, cs, cs, 3)))
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                out[path] = tuple(v.shape)

    walk(tree["params"], "")
    return out


def _port_shapes(component):
    from diffusiontexturepainting_torch.core import config as t_config
    from diffusiontexturepainting_torch.models.patch_encoder import (
        ConditionPatchEncoder)
    from diffusiontexturepainting_torch.models.unet import UNet2DCondition
    from diffusiontexturepainting_torch.models.vae import VAEEncoder

    with torch.device("meta"):
        m = {"unet": lambda: UNet2DCondition(t_config.UNetConfig()),
             "vae_encoder": lambda: VAEEncoder(t_config.VAEConfig()),
             "patch_encoder": lambda: ConditionPatchEncoder(
                 t_config.PatchEncoderConfig())}[component]()
    return {n: tuple(p.shape) for n, p in m.named_parameters()}


@pytest.fixture(scope="module", params=["unet", "vae_encoder",
                                        "patch_encoder"])
def component_shapes(request):
    return request.param, _port_shapes(request.param), \
        _jax_shapes(request.param)


@pytest.mark.parametrize("model_size", [2, 4])
def test_the_port_shards_what_param_spec_shards(component_shapes,
                                                model_size):
    from jax.sharding import PartitionSpec as P

    from diffusiontexturepainting_torch.weights.from_jax import torch_name
    from diffusiontexturepainting_tpu.parallel.mesh import param_spec

    comp, port, jax_shapes = component_shapes
    by_name = {torch_name(comp, p): s for p, s in jax_shapes.items()}
    assert set(by_name) == set(port)
    assert jax_leaf_shapes(comp, port) == by_name
    frozen = (lambda n: n.startswith("clip.")) if comp == "patch_encoder" \
        else (lambda n: True)
    want = {n for n, s in by_name.items()
            if frozen(n) and param_spec(s, model_size) != P()}
    got = {n for n in shard_dims(comp, port, model_size) if frozen(n)}
    assert got == want and want
    for n, dim in shard_dims(comp, port, model_size).items():
        assert port[n][dim] == by_name[n][-1]
        assert param_spec_dim(by_name[n], model_size) is not None


# --- train.main runs ---


@pytest.fixture(scope="module")
def textures(tmp_path_factory):
    d = tmp_path_factory.mktemp("textures")
    for i in range(6):
        rng = np.random.default_rng(i)
        y, x = np.mgrid[0:96, 0:112]
        a = np.stack([128 + 90 * np.sin(x / (5.0 + i) + c)
                      * np.cos(y / (8.0 + i) - c) for c in range(3)], -1)
        a = np.clip(a + rng.integers(-20, 20, a.shape), 0,
                    255).astype(np.uint8)
        image_io.write_png(d / f"t{i}.png", a)
    return str(d)


def argv(textures, out, *extra):
    return ["--images_path", textures, "--output_dir", str(out),
            "--device", "cpu", "--tiny", "--resolution", str(RES),
            "--train_batch_size", str(BATCH), "--checkpointing_steps", "1",
            "--max_train_steps", str(STEPS), "--validation_steps", "2",
            "--log_every", "1", "--learning_rate", str(LR), *extra]


def run(textures, tmp_path_factory, name, *flags):
    """(out dir, step records, report) of train.main; a lone rank runs on
    one torch thread, as each spawned rank does under this file's cap."""
    d = tmp_path_factory.mktemp(name)
    report = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, steps = train.main(argv(textures, d, *flags), timeout=RUN_TIMEOUT,
                              report=report)
    finally:
        torch.set_num_threads(threads)
    return str(d), steps, report


def load(out, *parts):
    path = os.path.join(out, *parts)
    if path.endswith(".npz"):
        return dict(np.load(path))
    return torch.load(path, map_location="cpu", weights_only=True)


def assert_bitwise_equal(a, b):
    (out_a, steps_a, _), (out_b, steps_b, _) = a, b
    assert [(s["loss"], s["grad_norm"]) for s in steps_a] == \
        [(s["loss"], s["grad_norm"]) for s in steps_b]
    for step in range(1, STEPS + 1):
        pa = load(out_a, "checkpoints", str(step), train.CHECKPOINT_FILE)
        pb = load(out_b, "checkpoints", str(step), train.CHECKPOINT_FILE)
        for k, v in pa["params"].items():
            assert torch.equal(v, pb["params"][k]), (step, k)
    for comp in ("unet", "patch_encoder"):
        ea = load(out_a, "export", f"{comp}.npz")
        eb = load(out_b, "export", f"{comp}.npz")
        assert set(ea) == set(eb)
        for k in ea:
            assert ea[k].tobytes() == eb[k].tobytes(), (comp, k)


@pytest.mark.parametrize("data", [1, 2])
def test_model_axis_is_bitwise_the_data_axis(textures, tmp_path_factory,
                                             data):
    plain = run(textures, tmp_path_factory, f"data{data}", "--mesh_data",
                str(data))
    sharded = run(textures, tmp_path_factory, f"data{data}_model2",
                  "--mesh_data", str(data), "--mesh_model", "2")
    assert_bitwise_equal(sharded, plain)
    ranks = sharded[2]["ranks"]
    assert [(r["rank"], r["data_index"], r["model_index"])
            for r in ranks] == [(i, i // 2, i % 2) for i in range(2 * data)]
    assert {r["world"] for r in ranks} == {2 * data}
    assert len({d for r in ranks for d in r["digests"]}) == 1
    assert [r["exported"] for r in ranks] == [True] + [False] * (
        2 * data - 1)
    whole = plain[2]["ranks"][0]["frozen_bytes"]
    assert all(r["frozen_bytes"] <= whole // 2 + whole // 8 for r in ranks)


# --- trainer level against JAX ---


def _trainer_rank(payload_path, cfg, rank, world, model, store, steps):
    """One gloo rank of a (world / model, model) mesh: the models from the
    payload's weights, its data index's rows of the batch and of each
    step's draws, the frozen towers sharded over its model group; returns
    the step metrics and the final trainables."""
    import torch.distributed as dist

    from diffusiontexturepainting_torch.core import config as t_config
    from diffusiontexturepainting_torch.models.patch_encoder import (
        ConditionPatchEncoder)
    from diffusiontexturepainting_torch.models.unet import UNet2DCondition
    from diffusiontexturepainting_torch.models.vae import VAEEncoder
    from diffusiontexturepainting_torch.parallel.mesh import (
        ModelShards, mesh_groups)
    from diffusiontexturepainting_torch.training import trainer as tr

    torch.set_num_threads(1)
    npz = dict(np.load(payload_path))
    sds, lora = {}, {}
    for key, v in npz.items():
        kind, _, rest = key.partition(":")
        if kind == "lora":
            name, part = rest.rsplit("/", 1)
            lora.setdefault(name, {})[part] = torch.from_numpy(v)
        elif kind in ("unet", "vae_encoder", "patch_encoder"):
            sds.setdefault(kind, {})[rest] = torch.from_numpy(v)
    cfg = tr.TrainConfig(**cfg)
    models = {"unet": UNet2DCondition(t_config.tiny_unet_config()),
              "vae_encoder": VAEEncoder(t_config.tiny_vae_config()),
              "patch_encoder": ConditionPatchEncoder(
                  t_config.tiny_patch_encoder_config())}
    for name, m in models.items():
        m.load_state_dict(sds[name])
        m.eval()
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        me = DataRank(rank, world, rank, "cpu", "gloo", model)
        data_group, model_group = mesh_groups(me)
        trainer = tr.Trainer(cfg, models, sds, "cpu", torch.float32,
                             lora=lora, shard=me.shard,
                             data_group=data_group)
        trainer.shards = ModelShards(
            {n: models[n] for n in ("unet", "vae_encoder",
                                    "patch_encoder")},
            me.model_index, model, model_group, "gloo",
            me.data_index * model)
        b = npz["batch:image"].shape[0] // me.data
        rows = slice(me.data_index * b, (me.data_index + 1) * b)
        batch = {k[len("batch:"):]: torch.from_numpy(v[rows])
                 for k, v in npz.items() if k.startswith("batch:")}
        metrics = []
        for i in range(steps):
            draws = {k.split(":", 2)[2]: torch.from_numpy(v[rows])
                     for k, v in npz.items() if k.startswith(f"draw:{i}:")}
            m = trainer.train_step(batch, draws)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return metrics, {k: v.detach().numpy().copy()
                         for k, v in trainer.params.items()}
    finally:
        dist.destroy_process_group()


def test_model_axis_step_matches_the_jax_mesh(tmp_path):
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from diffusiontexturepainting_torch.weights.from_jax import (
        lora_from_jax,
        state_dict_from_jax,
    )
    from diffusiontexturepainting_tpu.parallel.mesh import (
        make_mesh,
        shard_params,
    )
    from diffusiontexturepainting_tpu.training import trainer as j_trainer
    from tests import test_torch_port_training as tt
    from tests.test_torch_port_train_ddp_jax import _jax_params

    assert len(jax.devices()) >= 4
    params = _jax_params(tt)
    opts = tt.OPTIONS["epsilon"]
    cfg = j_trainer.TrainConfig(resolution=tt.RES, seed=tt.SEED,
                                **opts["cfg"])
    batch = tt.make_batch(opts["drop"])
    ju, je, jp = tt.jax_modules()
    _, clip = j_trainer.split_patch_encoder_params(params["patch_encoder"])
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    rep, data = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    frozen = {"unet": shard_params(params["unet"], mesh),
              "vae_encoder": shard_params(params["vae_encoder"], mesh),
              "clip": shard_params(clip, mesh)}
    assert any(leaf.sharding.spec != P() for leaf in
               jax.tree_util.tree_leaves(frozen["unet"]))
    state = j_trainer.create_train_state(cfg, params["unet"],
                                         params["patch_encoder"],
                                         lora_seed=0)
    lora0 = jax.tree_util.tree_map(np.array, state.trainable["lora"])
    state = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, rep) if hasattr(x, "shape") else x,
        state)
    jbatch = {k: jax.device_put(jnp.asarray(v), data if v.ndim > 1 else rep)
              for k, v in batch.items()}
    step = jax.jit(j_trainer.make_train_step(cfg, ju, je, jp))
    want = []
    with mesh:
        for _ in range(tt.STEPS):
            state, m = step(state, frozen, jbatch, jax.random.PRNGKey(tt.SEED))
            want.append((float(m["loss"]), float(m["grad_norm"])))
    final = jax.tree_util.tree_map(np.array, state.trainable)

    payload = {}
    for comp in ("unet", "vae_encoder", "patch_encoder"):
        for k, v in state_dict_from_jax(comp, params[comp]).items():
            payload[f"{comp}:{k}"] = v.numpy()
    for n, f in lora_from_jax(lora0).items():
        for part, v in f.items():
            payload[f"lora:{n}/{part}"] = v.numpy()
    for k, v in batch.items():
        payload[f"batch:{k}"] = v
    for i in range(tt.STEPS):
        for k, v in tt.jax_draws(i).items():
            payload[f"draw:{i}:{k}"] = v.numpy()
    path = str(tmp_path / "payload.npz")
    np.savez(path, **payload)
    store = str(tmp_path / "store")
    results = launch.run_local_ranks(
        _trainer_rank, [(path, dataclasses.asdict(cfg), r, 4, 2, store,
                         tt.STEPS) for r in range(4)], timeout=RUN_TIMEOUT)
    m0, p0 = results[0]
    for m, p in results[1:]:
        assert m == m0
        for k in p0:
            assert p0[k].tobytes() == p[k].tobytes(), k
    np.testing.assert_allclose(m0, want, rtol=tt.RTOL, atol=tt.ATOL)
    trainer = type("T", (), {"params": {k: torch.from_numpy(v)
                                        for k, v in p0.items()}})()
    tt.assert_trainables_close(trainer, final, cfg,
                               "data 2 x model 2 on 4 ranks")


# --- layouts ---


def test_mesh_layouts():
    axis = plan_data_axis(2, None, None, "cpu", 1, model=2)
    assert (axis.world, axis.data, axis.model, axis.backend) == (
        4, 2, 2, "gloo")
    assert [(axis.rank(i).data_index, axis.rank(i).model_index,
             axis.rank(i).shard) for i in range(4)] == [
        (0, 0, (0, 2)), (0, 1, (0, 2)), (1, 0, (1, 2)), (1, 1, (1, 2))]
    cards = plan_data_axis(None, None, None, "cuda", 8, model=2)
    assert (cards.world, cards.data, cards.local) == (8, 4, 8)
    with pytest.raises(ValueError, match="a model axis of 0"):
        plan_data_axis(1, None, None, "cpu", 1, model=0)
    with pytest.raises(ValueError, match=r"6 ranks \(3 data x 2 model\) do "
                                         "not divide over 4 processes"):
        plan_data_axis(3, 4, 0, "cpu", 1, model=2)


@pytest.mark.parametrize("flags, match", [
    (("--mesh_data", "3", "--mesh_model", "2"),
     "global batch: 3 data ranks must divide it"),
    (("--mesh_data", "1", "--mesh_model", "0"), "a model axis of 0 ranks"),
])
def test_model_axis_refusals(textures, tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        train.main(argv(textures, tmp_path, *flags), timeout=RUN_TIMEOUT)
