"""The multi-card paths on cards (`cuda` marker; each test skips below the
cards it needs). No JAX here: the oracles are the port's own.

- A kernel called on a tensor of cuda:1 from a thread whose current device
  is cuda:0 launches on cuda:1 (the profiler's kernel event names the
  device) and agrees with its plain version; a CUDA-graph program of an
  engine on cuda:1 captures and replays from that thread too, equal to
  the eager call, and the thread's current device stays cuda:0.
- `--mesh model=3` on three cards: a 256^2 / 4-step stamp byte-equal to
  the same stamp with its UNet evaluated a branch at a time on cuda:0, and
  the branch programs on each card.
- `--mesh data=2` on two cards: a batch of two requests as two shares,
  each byte-equal to its request batched alone on cuda:0.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

RES, STEPS = 256, 4


def _cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")


def test_a_kernel_launches_on_its_tensors_device():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffusiontexturepainting_torch.core.engine import Engine
    from diffusiontexturepainting_torch.ops.conv3x3 import conv3x3, conv_impl

    _cards(2)
    torch.cuda.set_device(0)
    gen = torch.Generator(device="cuda:1").manual_seed(0)
    dev = torch.device("cuda:1")
    x = torch.randn((2, 16, 16, 64), generator=gen, device=dev).bfloat16()
    w = (torch.randn((3, 3, 64, 128), generator=gen, device=dev)
         * 0.05).bfloat16()
    b = torch.randn((128,), generator=gen, device=dev).bfloat16()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = conv3x3(x, w, b)
        torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert kernels and {e.device_index for e in kernels} == {1}
    with conv_impl("plain"):
        want = conv3x3(x, w, b)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err < 2.0 ** -5

    engine = Engine(dev)
    prog = engine.program(("conv",), lambda x, w, b: (conv3x3(x, w, b),))
    (first,) = prog(x, w, b)
    (again,) = prog(x, w, b)
    assert prog.graph is not None and torch.equal(first, got)
    assert torch.equal(again, got) and torch.cuda.current_device() == 0


def _canvas():
    canvas = np.zeros((RES, RES, 4), np.uint8)
    canvas[: RES // 4, :, :3] = 64
    canvas[: RES // 4, :, 3] = 255
    return canvas


def test_cfg_stamp_on_three_cards_is_a_branch_at_a_time():
    from diffusiontexturepainting_torch.pipeline.inpaint import make_stamp_fn
    from diffusiontexturepainting_torch.parallel.mesh import make_cfg_mesh
    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter,
    )

    _cards(3)
    model = TorchConditionalInpainter(
        RES, cfg_mesh=make_cfg_mesh(3, ["cuda:0", "cuda:1", "cuda:2"]),
        verbose_timing=False)
    model.request_counter = 1
    got = model.generate_u8(_canvas(), steps=STEPS)
    assert len(model.cfg_unets.replicas) == 3
    for dev, engine in model.cfg_unets.engines.items():
        assert any(k[:2] == ("cfg", "exact") for k in engine.programs), dev

    unet = model.unet

    def branchwise(sample, t, ctx):
        return torch.cat([unet(sample[i:i + 1], t[i:i + 1], ctx[i:i + 1])
                          for i in range(3)])

    oracle = make_stamp_fn(branchwise, model.vae_encoder, model.vae_decoder,
                           STEPS, model.vae_encoder.cfg.scaling_factor)
    enc, init, _ = model.draws(2, RES, STEPS)
    c = model.config
    _, want = oracle(torch.from_numpy(_canvas())[None].cuda(), model._brush,
                     model._cond, model._uncond, enc, init,
                     c.guidance_scale, c.texture_guidance_scale,
                     c.texture_guidance_steps, c.context_pad)
    assert np.array_equal(got, want.cpu().numpy())


def test_data_mesh_shares_on_two_cards():
    from diffusiontexturepainting_torch.serving.parallel_model import (
        make_parallel_service,
    )

    _cards(2)
    two = make_parallel_service(RES, "data=2", max_batch=2,
                                devices=["cuda:0", "cuda:1"])
    one = make_parallel_service(RES, "data=1", max_batch=2,
                                model=two.base)
    session = one.new_session()
    payloads = [dict(canvas=_canvas(), image=session.image,
                     brush=session._brush, cond=session._cond,
                     uncond=session._uncond, counter=10 + i,
                     cfg_weight=2.0 + i, tg_weight=1.0, tg_steps=2,
                     context_pad=40) for i in range(2)]
    got = two._run_batch((RES, STEPS), payloads)
    assert [str(d) for d, _, _ in two.shares(2)] == ["cuda:0", "cuda:1"]
    assert set(str(d) for d in two._replicas) == {"cuda:0", "cuda:1"}
    for g, p in zip(got, payloads):
        assert np.array_equal(g, one._run_batch((RES, STEPS), [p])[0])
