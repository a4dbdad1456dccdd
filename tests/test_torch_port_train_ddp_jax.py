"""The port's sharded train step (training/trainer.py, shard=(rank,
world)) on two gloo ranks against the JAX train step under a data mesh, on
the CPU.

The JAX make_train_step runs in this process under make_mesh(data=2) on
two of the conftest's host devices, its batch sharded over `data` as the
JAX train.py shards it, in two option sets (epsilon; a 2-step warm-up with
2-step gradient accumulation). The port's step runs on two ranks spawned
by parallel/launch.py, fed the same weights, the same LoRA factors, each
rank its rows of the batch and of the JAX step's own draws (an npz file
the ranks read). The ranks' metrics and trainables are equal to each
other bit for bit; each micro-step's loss and grad_norm and the
trainables after four micro-steps match the JAX ones within
tests/test_torch_port_training.py's tolerance (its
assert_trainables_close). This module imports no JAX at its top: the
ranks import it to find their function.
"""

import numpy as np
import pytest
import torch

from diffusiontexturepainting_torch.parallel import launch

torch.set_num_threads(2)

RUN_TIMEOUT = 300  # seconds the spawned ranks may take before they die


JAX_OPTIONS = ("epsilon", "warmup_accum")


def _trainer_rank(payload_path, cfg, rank, world, store, steps):
    """One gloo rank of the trainer-level parity test: the models from the
    payload's weights, this rank's rows of the batch and of each step's
    draws, `steps` train steps under the TrainConfig fields `cfg`; returns
    the step metrics and the final trainables."""
    import torch.distributed as dist

    from diffusiontexturepainting_torch.core import config as t_config
    from diffusiontexturepainting_torch.models.patch_encoder import (
        ConditionPatchEncoder)
    from diffusiontexturepainting_torch.models.unet import UNet2DCondition
    from diffusiontexturepainting_torch.models.vae import VAEEncoder
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
        trainer = tr.Trainer(cfg, models, sds, "cpu", torch.float32,
                             lora=lora, shard=(rank, world))
        b = npz["batch:image"].shape[0] // world
        rows = slice(rank * b, (rank + 1) * b)
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


def _jax_params(tt):
    """tests/test_torch_port_training.py's seeded JAX weights."""
    import jax.numpy as jnp

    from diffusiontexturepainting_tpu.core import config as j_config
    from tests.test_torch_port_modules import jax_init

    ju, je, jp = tt.jax_modules()
    pcfg = j_config.tiny_patch_encoder_config()
    lat = tt.RES // 8
    return {
        "unet": jax_init(ju, jnp.zeros((1, lat, lat, 9)), jnp.float32(0.0),
                         jnp.zeros((1, 14, 32)), seed=1),
        "vae_encoder": jax_init(je, jnp.zeros((1, tt.RES, tt.RES, 3)),
                                seed=2),
        "patch_encoder": jax_init(
            jp, jnp.zeros((1, pcfg.total_patches, pcfg.clip.image_size,
                           pcfg.clip.image_size, 3)),
            return_uncond_vector=True, seed=4),
    }


def _jax_mesh_run(tt, params, name):
    """The JAX make_train_step under make_mesh(data=2) on two host
    devices, the batch sharded over data as the JAX train.py shards it:
    (cfg, batch, lora0, per-step (loss, grad_norm), final trainables)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from diffusiontexturepainting_tpu.parallel.mesh import make_mesh
    from diffusiontexturepainting_tpu.training import trainer as j_trainer

    opts = tt.OPTIONS[name]
    cfg = j_trainer.TrainConfig(resolution=tt.RES, seed=tt.SEED,
                                **opts["cfg"])
    batch = tt.make_batch(opts["drop"])
    ju, je, jp = tt.jax_modules()
    _, clip = j_trainer.split_patch_encoder_params(params["patch_encoder"])
    mesh = make_mesh(data=2, model=1, devices=jax.devices()[:2])
    rep, data = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    frozen = jax.device_put({"unet": params["unet"],
                             "vae_encoder": params["vae_encoder"],
                             "clip": clip}, rep)
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
    metrics = []
    with mesh:
        for _ in range(tt.STEPS):
            state, m = step(state, frozen, jbatch, jax.random.PRNGKey(tt.SEED))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    assert len(jbatch["image"].sharding.device_set) == 2
    final = jax.tree_util.tree_map(np.array, state.trainable)
    return cfg, batch, lora0, metrics, final


@pytest.mark.parametrize("name", JAX_OPTIONS)
def test_sharded_step_matches_jax_data_mesh(name, tmp_path):
    import dataclasses

    import jax

    from diffusiontexturepainting_torch.weights.from_jax import (
        lora_from_jax,
        state_dict_from_jax,
    )
    from tests import test_torch_port_training as tt

    assert len(jax.devices()) >= 2
    params = _jax_params(tt)
    cfg, batch, lora0, want, final = _jax_mesh_run(tt, params, name)
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
    fields = dataclasses.asdict(cfg)
    results = launch.run_local_ranks(
        _trainer_rank, [(path, fields, r, 2, store, tt.STEPS)
                        for r in range(2)], timeout=RUN_TIMEOUT)
    (m0, p0), (m1, p1) = results
    assert m0 == m1
    for k in p0:
        assert p0[k].tobytes() == p1[k].tobytes(), k
    np.testing.assert_allclose(m0, want, rtol=tt.RTOL, atol=tt.ATOL)
    trainer = type("T", (), {"params": {k: torch.from_numpy(v)
                                        for k, v in p0.items()}})()
    tt.assert_trainables_close(trainer, final, cfg, f"{name} on 2 ranks")
