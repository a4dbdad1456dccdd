"""CFG-branch model parallelism: the 3-branch UNet batch over 3 devices.

Port of the JAX package's parallel/cfg_shard.py. Every denoise step runs
the UNet on a CFG triple batch [uncond, cond, texture-guided]; the three
branches are independent until the guidance combine, so branch i runs on
device i of a CfgMesh (parallel/mesh.py), at batch 1 with the served
kernels, and only its noise prediction comes back to the lead device
(devices[0]) for the combine. The VAE encode and decode, the scheduler,
the brush encoder and the composite stay on the lead device, where their
results are used; nothing of them is replicated.

`CfgShardedUNets` gives make_stamp_fn (pipeline/inpaint.py) the four
UNet callables it takes (`unet`, `unet_full`, `unet_shallow`,
`unet_final`), as the JAX cfg_sharded_models replaces the four applies:

  - each branch call is a program of its device's engine (core/engine.py):
    on CUDA a CUDA graph per (kind, shapes), captured at its first call and
    replayed, its inputs copied in from the lead device by the program's
    fill and its outputs cloned on its device; on the CPU the same
    function eagerly;
  - a full call returns the DeepCache feature of each branch on the
    branch's device (a tuple of three), and a shallow call reads each
    there: the cache never crosses devices;
  - the f32 final step runs each branch on its device's fp32 UNet.

The lead device's VAE encode and decode are programs of its engine too,
and the stamp around them (the glue: the mask split, the combine, the
scheduler step) runs eagerly on the lead (core/engine.py Stamp with
graphed=False): a CUDA graph captures one device's work, so the stamp is
a chain of per-device graphs joined by the copies' stream waits, and the
host never waits inside it.

Replicas: one UNet (and, with the f32 final step, one fp32 UNet) a
distinct device; a device listed twice shares its replica and its engine,
so a mesh of one card repeated holds the lead model's UNet once and runs
the branches one after another. `refresh()` copies the lead's weights into
every replica in place (load_state_dict's copy_), so the captured graphs
keep reading them (ROADMAP.md's Watch list: a captured graph reads
addresses).
"""

from __future__ import annotations

import torch

from ..core.engine import Engine

BRANCHES = 3


class CfgShardedUNets:
    """The UNet calls of a stamp, a guidance branch a device of `mesh`.

    unet (and final_unet, or None) are the lead model's, on devices[0];
    engine is the lead model's engine; make_replica(device) -> (unet,
    final_unet) builds another device's modules (weights not yet set)."""

    def __init__(self, mesh, unet, final_unet, engine: Engine,
                 make_replica):
        if len(mesh.devices) != BRANCHES:
            raise ValueError(
                f"CFG-branch sharding needs mesh axis 'model'=3 (one chip "
                f"per guidance branch), got {{'model': {len(mesh.devices)}}}")
        self.mesh = mesh
        self.devices = [torch.device(d) for d in mesh.devices]
        if engine.device != self.devices[0]:
            raise ValueError(f"the lead model is on {engine.device}, the "
                             f"mesh's lead device is {self.devices[0]}")
        self.replicas = {engine.device: (unet, final_unet)}
        self.engines = {engine.device: engine}
        for dev in dict.fromkeys(self.devices):
            if dev not in self.replicas:
                self.replicas[dev] = make_replica(dev)
                self.engines[dev] = Engine(dev)
        self.refresh()

    @torch.no_grad()
    def refresh(self) -> None:
        """Every other device's replica := the lead's weights, copied in
        place."""
        unet, final = self.replicas[self.devices[0]]
        sd = unet.state_dict()
        for dev, (u, f) in self.replicas.items():
            if u is not unet:
                u.load_state_dict(sd)
                if f is not None:
                    f.load_state_dict(sd)

    def _program(self, i: int, kind: str, args):
        """Branch i's program of `kind` for `args` on its device."""
        dev = self.devices[i]
        unet, final = self.replicas[dev]
        if kind == "exact":
            fn = lambda s, t, c: (unet(s, t, c),)  # noqa: E731
        elif kind == "full":
            fn = unet.forward_full
        elif kind == "shallow":
            fn = lambda s, t, c, cache: (  # noqa: E731
                unet.forward_shallow(s, t, c, cache),)
        else:
            fn = lambda s, t, c: (final(s, t, c),)  # noqa: E731
        key = ("cfg", kind) + tuple(
            (tuple(a.shape), str(a.dtype)) for a in args)
        return self.engines[dev].program(key, fn)

    def _call(self, kind: str, sample, t, ctx, cache=None):
        """Every branch's call enqueued on its device, then the noise
        predictions gathered on the lead device: (eps (3B, ...), the
        branches' outputs)."""
        B = sample.shape[0] // BRANCHES
        t = t.expand(sample.shape[0]) if t.dim() == 0 else t
        outs = []
        for i in range(BRANCHES):
            part = slice(i * B, (i + 1) * B)
            args = (sample[part], t[part], ctx[part])
            if cache is not None:
                args += (cache[i],)
            outs.append(self._program(i, kind, args)(*args))
        lead = sample.device
        eps = torch.cat([o[0].to(lead) for o in outs], dim=0)
        return eps, outs

    def unet(self, sample, t, ctx):
        return self._call("exact", sample, t, ctx)[0]

    def unet_full(self, sample, t, ctx):
        """(eps, cache): cache a tuple, each branch's on its device."""
        eps, outs = self._call("full", sample, t, ctx)
        return eps, tuple(o[1] for o in outs)

    def unet_shallow(self, sample, t, ctx, cache):
        return self._call("shallow", sample, t, ctx, cache)[0]

    def unet_final(self, sample, t, ctx):
        return self._call("final", sample, t, ctx)[0]

    def lead_program(self, name: str, module):
        """module(x) as a program of the lead device's engine (the VAE
        encode and decode)."""
        engine = self.engines[self.devices[0]]

        def call(x):
            prog = engine.program(("cfg", name, tuple(x.shape),
                                   str(x.dtype)), lambda y: (module(y),))
            return prog(x)[0]

        call.cfg = getattr(module, "cfg", None)
        return call
