"""Lightning-on-Spark MNIST through the port's LightningEstimator; the
port's copy of examples/spark/lightning_spark_mnist.py (reference:
examples/spark/pytorch_lightning_spark_mnist.py: fit a LightningModule on
Spark workers with callbacks and a logger, then score with the returned
transformer).

Shows the Lightning trainer surface the estimator carries: the module's
own ``configure_optimizers``/``training_step``/``validation_step`` hooks,
a duck-typed callback with an early stop synced across the workers, a
``log_metrics`` logger fed by ``self.log``, and ``gradient_clip_val``.
pytorch_lightning is not needed: any object speaking the LightningModule
protocol trains.  Each task trains on its card, or on the CPU with
``--cpu``.

    python examples/torch_port/lightning_spark_mnist.py --np 1
    python examples/torch_port/lightning_spark_mnist.py --np 2 --cpu
"""

import argparse
import json
import os
import tempfile


class MnistModule:
    """A LightningModule-protocol classifier (a ``pl.LightningModule``
    subclass drops in unchanged).  It has no ``.to``: the estimator builds
    it on the task's device."""

    def __init__(self):
        import torch
        self.net = torch.nn.Sequential(
            torch.nn.Linear(784, 128), torch.nn.ReLU(),
            torch.nn.Linear(128, 10))

    # --- the protocol's plumbing, which the trainer loop drives ---------
    def parameters(self):
        return self.net.parameters()

    def state_dict(self):
        return self.net.state_dict()

    def load_state_dict(self, sd):
        self.net.load_state_dict(sd)

    def train(self):
        self.net.train()

    def eval(self):
        self.net.eval()

    def __call__(self, x):
        return self.net(x)

    # --- the Lightning hooks --------------------------------------------
    def configure_optimizers(self):
        import torch
        opt = torch.optim.Adam(self.net.parameters(), lr=0.05)
        sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1,
                                                gamma=0.7)
        return {"optimizer": opt,
                "lr_scheduler": {"scheduler": sched, "interval": "epoch"}}

    def training_step(self, batch, batch_idx):
        import torch
        x, y = batch
        loss = torch.nn.functional.cross_entropy(
            self.net(x), y.ravel().long())
        self.log("train_ce", loss)
        return loss

    def validation_step(self, batch, batch_idx):
        import torch
        x, y = batch
        logits = self.net(x)
        self.log("val_acc",
                 (logits.argmax(dim=1) == y.ravel().long()).float().mean())
        return torch.nn.functional.cross_entropy(logits, y.ravel().long())


class StopWhenGoodEnough:
    """A duck-typed Lightning callback: stops early on the validation
    accuracy the module logs, which is the same on every worker."""

    def __init__(self, target=0.95):
        self.target = target

    def on_train_epoch_end(self, trainer, module):
        if trainer.callback_metrics.get("val_acc", 0.0) >= self.target:
            trainer.should_stop = True  # synced across the workers


class JsonlLogger:
    """A minimal Lightning-Logger-protocol sink."""

    def __init__(self, path):
        self.path = path

    def log_metrics(self, metrics, step=None):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **metrics}) + "\n")

    def finalize(self, status):
        with open(self.path, "a") as f:
            f.write(json.dumps({"finalized": status}) + "\n")


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


def fit(store, log_path, num_proc=2, epochs=4, batch=128,
        coordinator_port=29511, executor=None, logger=None, callbacks=()):
    """The example's estimator on ``store``: the fitted model, its holdout
    accuracy and the logger's rows (``logger`` defaults to a
    :class:`JsonlLogger` at ``log_path``)."""
    import numpy as np
    from horovod_tpu_torch.spark import LightningEstimator

    x, y = make_mnist_like()
    est = LightningEstimator(
        store=store, model_fn=MnistModule, num_proc=num_proc,
        feature_cols=["features"], label_cols=["label"],
        batch_size=batch, epochs=epochs, validation=0.2,
        callbacks=[StopWhenGoodEnough(), *callbacks],
        logger=logger or JsonlLogger(log_path), log_every_n_steps=10,
        gradient_clip_val=5.0, coordinator_port=coordinator_port,
        executor=executor)
    model = est.fit({"features": x, "label": y})
    xt, yt = make_mnist_like(n=1024, seed=1)
    pred = model.transform({"features": xt})["predict"]
    acc = float(np.mean(np.argmax(pred, axis=1) == yt.ravel()))
    with open(log_path) as f:
        rows = [json.loads(line) for line in f]
    return model, acc, rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--np", type=int, default=2, dest="num_proc")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--coordinator-port", type=int, default=29511)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()
    if args.cpu:
        from horovod_tpu_torch.utils.platform import force_cpu
        force_cpu()

    from horovod_tpu_torch.spark import FilesystemStore
    with tempfile.TemporaryDirectory() as tmp:
        model, acc, rows = fit(
            FilesystemStore(tmp), os.path.join(tmp, "metrics.jsonl"),
            args.num_proc, args.epochs, args.batch, args.coordinator_port)
    print("per-epoch history:")
    for name, series in model.history.items():
        print(f"  {name}: " + " ".join(f"{v:.4f}" for v in series))
    logged = sorted({k for r in rows for k in r
                     if k not in ("step", "finalized")})
    print(f"logger captured {len(rows)} rows; metrics: {logged}")
    print(f"holdout accuracy {acc:.3f}")
    if not acc > 0.8:
        raise SystemExit("estimator failed to learn the class templates")
    if "val_loss" not in model.history or \
            not {"train_ce", "val_acc"} <= set(logged):
        raise SystemExit(f"history {sorted(model.history)}, logged {logged}")
    print("OK")


if __name__ == "__main__":
    main()
