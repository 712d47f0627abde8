"""The port's counterparts of examples/jax/resnet50_train.py and
bert_ulysses_sp.py (examples/torch_port/), launched with ``--cpu`` as a
user starts them: ResNet-50 on two gloo ranks with sync-BN resumes from
its own checkpoint to the same loss (bitwise: the same ops on the same
restored state and batch); BERT ``tiny`` under Ulysses on two ranks gives
one rank's losses over the whole sequence (within 1e-4 relative: the
shares' sum and the gradients' sum reorder fp32 additions) and its
masked-LM loss drops."""

from torch_port_examples import launch_example, losses

STEP = r"step (\d+): loss ([0-9.]+)"


def test_resnet50_train_resumes_to_the_same_loss(tmp_path):
    args = ("--steps", "4", "--ckpt-every", "2", "--batch", "2",
            "--ckpt-dir", str(tmp_path / "ckpt"))
    first = launch_example(2, "resnet50_train.py", *args)
    assert "done" in first and "resumed" not in first, first
    again = launch_example(2, "resnet50_train.py", *args)
    assert "resumed from step 2" in again, again
    a, b = losses(first, STEP), losses(again, STEP)
    assert set(b) == {3} and b[3] == a[3], (a, b)


def test_bert_ulysses_two_ranks_match_one_rank():
    pattern = r"step +(\d+) +mlm loss ([0-9.]+)"
    one = losses(launch_example(1, "bert_ulysses_sp.py", "--steps", "40"),
                 pattern)
    out = launch_example(2, "bert_ulysses_sp.py", "--steps", "40")
    two = losses(out, pattern)
    assert "OK" in out and sorted(one) == sorted(two) == [0, 10, 20, 30, 39]
    for s in one:
        assert abs(one[s] - two[s]) <= 1e-4 * one[s], (s, one[s], two[s])
