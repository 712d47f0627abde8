"""The port's counterparts of examples/pytorch/ (examples/torch_port/),
each launched on two gloo ranks with ``--cpu`` as a user starts it:
MNIST trains to its validation accuracy and resumes from its checkpoint,
the synthetic benchmark reports images/s, the elastic example runs its
epochs under ``@hvd.elastic.run``."""

import re

from torch_port_examples import launch_example


def test_pytorch_mnist_learns_and_resumes(tmp_path):
    ckpt = str(tmp_path / "mnist.pt")
    out = launch_example(2, "pytorch_mnist.py", "--epochs", "3", "--ckpt",
                         ckpt)
    accs = [float(a) for a in re.findall(r"val_acc ([0-9.]+)", out)]
    assert len(accs) == 3 and accs[-1] > 0.5 and "done" in out, out
    out = launch_example(2, "pytorch_mnist.py", "--epochs", "3", "--ckpt",
                         ckpt)
    assert "resuming from epoch 3" in out and "nothing to do" in out, out


def test_pytorch_synthetic_benchmark_reports_throughput():
    out = launch_example(2, "pytorch_synthetic_benchmark.py",
                         "--num-iters", "3", "--num-warmup", "1")
    assert re.search(r"Total img/sec on 2 ranks: [0-9.]+", out), out


def test_pytorch_elastic_runs_its_epochs():
    out = launch_example(2, "pytorch_elastic.py", "--epochs", "2",
                         "--batches-per-epoch", "6")
    assert re.findall(r"epoch (\d): loss=", out) == ["0", "1"], out
