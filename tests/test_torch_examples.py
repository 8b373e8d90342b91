"""The example twins (``repro_torch.examples``) on the CPU.

``kernel_autotune`` at the reference's sizes with ``--device cpu`` (the
kernel's plain version at TCM's tiles, held against the oracle), and
``train_e2e`` for 4 steps with ``--device cpu``; ``quickstart`` is a text
copy of the reference's, held by ``test_torch_mapper_parity.py``.
Without ``--device cpu`` both need the card.
"""
import pytest
import torch

from repro_torch.examples import kernel_autotune, train_e2e


def test_kernel_autotune_on_cpu(capsys):
    assert kernel_autotune.main(["--device", "cpu"]) is True
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("kernel vs oracle max |err| = ")
    assert out[-1].endswith("(OK)")
    tiles = [ln for ln in out if ln.startswith("matmul ")]
    assert [ln.split(":")[0] for ln in tiles] == [
        "matmul 1024x1024x1024", "matmul 4096x768x3072"]
    assert sum("kernel takes it: True" in ln for ln in out) == 2
    assert "kernel launches: 0 on cpu" in out


def test_train_e2e_on_cpu(tmp_path, capsys):
    loss = train_e2e.main(["--steps", "4", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith(f"checkpoints -> {tmp_path}\n"
                          "mesh: {'data': 1, 'model': 1} devices=1\n")
    assert f"final loss: {loss:.4f}" in out
    assert (tmp_path / "step_00000004").is_dir()


def test_examples_need_the_card_unless_the_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_autotune.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_e2e.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
