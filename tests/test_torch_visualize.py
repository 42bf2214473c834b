"""The port's offline plots (`ldm3d_torch.utils.visualize`) against the
JAX package's, on the CPU: `read_training_log` on one log (a column that
appears mid-run included), and both plots and the command line write
PNGs."""

import numpy as np
import pytest

from ldm3d.utils import visualize as jvis
from ldm3d_torch.utils import visualize as vis

LOG = ("epoch,loss,reconst_loss,val_loss,latent_fid\n"
       "0,0.1,0.09,0.12,\n1,0.05,0.04,0.06,\n2,0.02,0.018,0.03,7.5\n")


def _log(tmp_path, name="training.log"):
    path = tmp_path / name
    path.write_text(LOG)
    return str(path)


def test_read_training_log_equals_jax(tmp_path):
    log = _log(tmp_path)
    got, ref = vis.read_training_log(log), jvis.read_training_log(log)
    assert list(got) == list(ref) == ["epoch", "loss", "reconst_loss",
                                      "val_loss", "latent_fid"]
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    assert np.isnan(got["latent_fid"][0]) and got["latent_fid"][2] == 7.5
    (tmp_path / "empty.log").write_text("epoch,loss\n")
    assert vis.read_training_log(str(tmp_path / "empty.log")) == {}


@pytest.mark.parametrize("logy", [True, False])
def test_plots_write_pngs(tmp_path, logy):
    runs = [tmp_path / "a", tmp_path / "b"]
    for r in runs:
        r.mkdir()
    logs = [_log(r) for r in runs]
    out = vis.plot_loss_curves(logs, str(tmp_path / "loss.png"),
                               metrics=["loss", "val_loss"], logy=logy)
    assert out.endswith("loss.png")
    assert (tmp_path / "loss.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    rng = np.random.default_rng(0)
    np.save(tmp_path / "recon.npy",
            rng.random((3, 8, 8, 8, 1)).astype(np.float32))
    np.save(tmp_path / "one.npy", rng.random((8, 8, 8)).astype(np.float32))
    vis.plot_volume_grid([str(tmp_path / "recon.npy"),
                          str(tmp_path / "one.npy")],
                         str(tmp_path / "vols.png"), max_items=4)
    assert (tmp_path / "vols.png").read_bytes()[:4] == b"\x89PNG"


def test_cli_writes_both_plots(tmp_path, capsys):
    log = _log(tmp_path)
    np.save(tmp_path / "v.npy", np.zeros((1, 8, 8, 8, 1), np.float32))
    vis.main(["loss", log, "--out", str(tmp_path / "l.png"), "--linear"])
    vis.main(["volumes", str(tmp_path / "v.npy"), "--out",
              str(tmp_path / "v.png")])
    assert (tmp_path / "l.png").exists() and (tmp_path / "v.png").exists()
    assert capsys.readouterr().out.count("wrote") == 2
