"""Torch-on-Spark MNIST classification through the port's TorchEstimator;
the port's copy of examples/spark/pytorch_spark_mnist.py (reference:
examples/spark/pytorch/pytorch_spark_mnist.py: fit a torch model on Spark
workers through the estimator, then score with the returned transformer).

Runs with or without pyspark: the estimator places its tasks on a live
Spark cluster when pyspark imports, else on local processes.  Each task
trains on its card, or on the CPU with ``--cpu``.

    python examples/torch_port/pytorch_spark_mnist.py --np 1
    python examples/torch_port/pytorch_spark_mnist.py --np 2 --cpu
"""

import argparse
import functools
import tempfile


def model_fn():
    """Module-level, so the train task pickles to the workers (the
    reference's estimators ship models the same way)."""
    import torch
    return torch.nn.Sequential(
        torch.nn.Linear(784, 128), torch.nn.ReLU(),
        torch.nn.Linear(128, 10))


def adam_fn(params, lr=0.05):
    import torch
    return torch.optim.Adam(params, lr=lr)


def make_mnist_like(n=4096, classes=10, dim=784, seed=0):
    """The JAX example's data: class templates from a fixed stream, so the
    train set (seed 0) and the holdout (seed 1) share the 10 classes; the
    noise and the labels vary with ``seed``."""
    import numpy as np
    templates = np.random.RandomState(99).randn(classes, dim).astype(
        "float32")
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, n)
    x = templates[y] + 0.7 * rng.randn(n, dim).astype("float32")
    return x, y.astype("float32").reshape(-1, 1)


def fit(store, num_proc=2, epochs=4, batch=128, lr=0.05,
        coordinator_port=29511, executor=None):
    """The example's estimator on ``store``: the fitted model and its
    holdout accuracy."""
    import numpy as np
    from horovod_tpu_torch.spark import TorchEstimator

    x, y = make_mnist_like()
    est = TorchEstimator(
        store=store, model_fn=model_fn, num_proc=num_proc,
        feature_cols=["features"], label_cols=["label"],
        batch_size=batch, epochs=epochs,
        loss="cross_entropy", metrics=["accuracy"], validation=0.2,
        optimizer_fn=functools.partial(adam_fn, lr=lr),
        coordinator_port=coordinator_port, executor=executor)
    model = est.fit({"features": x, "label": y})
    xt, yt = make_mnist_like(n=1024, seed=1)
    pred = model.transform({"features": xt})["predict"]
    acc = float(np.mean(np.argmax(pred, axis=1) == yt.ravel()))
    return model, acc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--np", type=int, default=2, dest="num_proc")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--coordinator-port", type=int, default=29511)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()
    if args.cpu:
        from horovod_tpu_torch.utils.platform import force_cpu
        force_cpu()

    from horovod_tpu_torch.spark import FilesystemStore
    with tempfile.TemporaryDirectory() as tmp:
        model, acc = fit(FilesystemStore(tmp), args.num_proc, args.epochs,
                         args.batch, args.lr, args.coordinator_port)
    print("per-epoch history:")
    for name, series in model.history.items():
        print(f"  {name}: " + " ".join(f"{v:.4f}" for v in series))
    print(f"holdout accuracy {acc:.3f}")
    if not acc > 0.8:
        raise SystemExit("estimator failed to learn the class templates")
    print("OK")


if __name__ == "__main__":
    main()
