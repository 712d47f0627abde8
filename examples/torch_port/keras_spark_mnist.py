"""Keras-on-Spark MNIST through the port's KerasEstimator; the port's copy
of examples/spark/keras_spark_mnist.py (reference:
examples/spark/keras/keras_spark_mnist.py: build a Keras model, fit it on
Spark workers through the estimator, score with the returned
transformer).

keras runs on its torch backend: the estimator's tasks set
``KERAS_BACKEND=torch``, and so does this script before keras is first
imported.  Each task trains on its card, or on the CPU with ``--cpu``.

    python examples/torch_port/keras_spark_mnist.py --np 1
    python examples/torch_port/keras_spark_mnist.py --np 2 --cpu
"""

import argparse
import os
import tempfile


def model_fn():
    """Module-level, so the train task pickles to the workers."""
    import keras
    return keras.Sequential([
        keras.Input((784,)),
        keras.layers.Dense(128, activation="relu"),
        keras.layers.Dense(10, activation="softmax"),
    ])


def make_mnist_like(n=4096, classes=10, dim=784, seed=0):
    """The JAX example's data: class templates from a fixed stream, so the
    train set (seed 0) and the holdout (seed 1) share the 10 classes."""
    import numpy as np
    templates = np.random.RandomState(99).randn(classes, dim).astype(
        "float32")
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, n)
    x = templates[y] + 0.7 * rng.randn(n, dim).astype("float32")
    return x, y.astype("float32").reshape(-1, 1)


def fit(store, num_proc=2, epochs=4, batch=128, lr=0.5,
        coordinator_port=29511, executor=None):
    """The example's estimator on ``store``: the fitted model and its
    holdout accuracy."""
    import numpy as np
    from horovod_tpu_torch.spark import KerasEstimator

    x, y = make_mnist_like()
    est = KerasEstimator(
        store=store, model_fn=model_fn, num_proc=num_proc,
        feature_cols=["features"], label_cols=["label"],
        batch_size=batch, epochs=epochs, lr=lr,
        loss="sparse_categorical_crossentropy", metrics=["accuracy"],
        validation=0.2, coordinator_port=coordinator_port,
        executor=executor)
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
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--coordinator-port", type=int, default=29511)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()
    if args.cpu:
        from horovod_tpu_torch.utils.platform import force_cpu
        force_cpu()
    os.environ["KERAS_BACKEND"] = "torch"

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
