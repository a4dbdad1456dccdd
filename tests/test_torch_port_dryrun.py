"""parallel/dryrun.py, the counterpart of the JAX package's
`__graft_entry__.py multichip N`, at N = 4 on the CPU: one training step
on a (2 data x 2 model) mesh of four gloo ranks (every rank's trainables
equal, the frozen towers sharded), one `data=4` batch of four requests a
share each, one `model=3` stamp."""

import torch

from diffusiontexturepainting_torch.parallel import dryrun

torch.set_num_threads(2)


def test_dryrun_on_four_cpu_devices():
    record = dryrun.main(["4", "--device", "cpu"])
    assert record["devices"] == ["cpu"] * 4 and record["model_axis"] == 2
    ranks = record["train"]["ranks"]
    assert record["train"]["mesh"] == [2, 2]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert len({r["digest"] for r in ranks}) == 1
    assert len({r["loss"] for r in ranks}) == 1
    assert record["data"] == {"stamps": 4, "shares": ["cpu"] * 4,
                              "replicas": 1}
    assert record["cfg"] == {"shape": [64, 64, 3],
                             "devices": ["cpu"] * 3, "replicas": 1}


def test_model_axis_of():
    assert [dryrun.model_axis_of(n) for n in (1, 2, 3, 4, 6, 8)] == [
        1, 1, 1, 2, 2, 2]
