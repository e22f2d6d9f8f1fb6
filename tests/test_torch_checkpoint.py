"""`priors.conv_ae.load_torch_state_dict` in both packages: a plain
`state_dict` checkpoint through the safe load, and checkpoints that the
safe load refuses (a pickled `torch.nn.Sequential` of convolutions, a
pickled dict holding one) through the legacy loader, which `lemo_tpu`
falls back to and the port must too. Each gives the same flat dict of
float32 arrays, bit for bit, in both packages."""

import numpy as np
import pytest
import torch

from lemo_tpu.priors.conv_ae import load_torch_state_dict as j_load
from lemo_tpu_torch.priors.conv_ae import load_torch_state_dict as t_load


def _convs():
    torch.manual_seed(0)
    return torch.nn.Sequential(
        torch.nn.Conv2d(1, 4, 3, padding=1), torch.nn.LeakyReLU(0.2),
        torch.nn.Conv2d(4, 8, 3, stride=2), torch.nn.ConvTranspose2d(8, 2, 3))


@pytest.mark.parametrize("form", ["state_dict", "module", "dict_of_module"])
def test_checkpoint_loads_alike(tmp_path, form):
    net = _convs()
    obj = {"state_dict": net.state_dict(), "module": net,
           "dict_of_module": {"model": net}}[form]
    path = str(tmp_path / "ckpt.pkl")
    torch.save(obj, path)
    if form != "state_dict":
        with pytest.raises(Exception):
            torch.load(path, map_location="cpu", weights_only=True)
    got = t_load(path, "cpu")
    ref = j_load(path)
    if form == "dict_of_module":
        # neither package unwraps a dict of modules: it holds no tensor
        assert got == {} and ref == {}
        return
    want = net.state_dict()
    assert sorted(got) == sorted(ref) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        np.testing.assert_array_equal(got[k].numpy(), v.numpy())
