"""The Spark estimator workflow on the port; its copy of
examples/spark/spark_estimator.py (reference: the
keras_spark_rossmann_estimator pattern, distilled): persist a dataset
through a Store, fit a LinearEstimator on N workers with synchronized
gradients, placed elastically, resume it from its epoch checkpoint with
``fit_on_parquet``, and transform new data with the returned model.

Runs with or without pyspark (local processes stand in for Spark's
executors).  Each task trains on its card, or on the CPU with ``--cpu``.

    python examples/torch_port/spark_estimator.py --np 1
    python examples/torch_port/spark_estimator.py --np 2 --cpu
"""

import argparse
import tempfile


def make_data(n=512, seed=0):
    import numpy as np
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype("float32")
    w_true = np.array([[1.0], [-2.0], [0.5], [3.0]], "float32")
    y = (x @ w_true + 0.01 * rng.randn(n, 1)).astype("float32")
    return x, y


def estimator(store, num_proc, epochs, coordinator_port=29511):
    from horovod_tpu_torch.spark import LinearEstimator
    return LinearEstimator(
        store=store, num_proc=num_proc,
        feature_cols=["features"], label_cols=["label"],
        batch_size=64, epochs=epochs, lr=0.1,
        validation=0.25, metrics=["mse", "mae"],
        coordinator_port=coordinator_port)


def workflow(store, num_proc=2, epochs=3, coordinator_port=29511):
    """``fit(elastic=True)`` for ``epochs``, then ``fit_on_parquet`` to
    ``epochs + 2`` from the epoch checkpoint: both models."""
    x, y = make_data()
    # elastic=True: a lost worker shrinks the job, and training resumes
    # from the last epoch checkpoint
    first = estimator(store, num_proc, epochs, coordinator_port).fit(
        {"features": x, "label": y}, elastic=True, min_np=1)
    # the epoch checkpoint makes a re-fit a continuation
    est2 = estimator(store, num_proc, epochs + 2, coordinator_port)
    if not est2.has_checkpoint():
        raise SystemExit("expected the epoch checkpoint from fit()")
    return first, est2.fit_on_parquet()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--np", type=int, default=2, dest="num_proc")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--coordinator-port", type=int, default=29511)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()
    if args.cpu:
        from horovod_tpu_torch.utils.platform import force_cpu
        force_cpu()

    from horovod_tpu_torch.spark import FilesystemStore
    x, y = make_data()
    with tempfile.TemporaryDirectory() as tmp:
        first, model = workflow(FilesystemStore(tmp), args.num_proc,
                                args.epochs, args.coordinator_port)
    print("per-epoch history:")
    for name, series in first.history.items():
        print(f"  {name}: " + " ".join(f"{v:.4f}" for v in series))
    print(f"resumed to {len(model.history['train_loss'])} epochs")
    out = model.transform({"features": x[:8], "label": y[:8]})
    print("features -> predictions vs labels:")
    for pred, label in zip(out["predict"][:8], y[:8]):
        print(f"  {pred.item():8.3f}  {label.item():8.3f}")


if __name__ == "__main__":
    main()
