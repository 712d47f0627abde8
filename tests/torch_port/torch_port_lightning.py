"""LightningModule-protocol modules, callbacks and a logger that the
Lightning estimator tests hand to both packages' ``LightningEstimator``
(``tests/test_spark_ray.py``'s, with the modules' initial weights seeded).
The train tasks are processes of their own, so observations go through
files.  Imports torch only, so a task that unpickles them loads neither
package."""

import json

CLIP = 0.5


class ToyModule:
    """configure_optimizers (SGD and a StepLR as ``[opt], [sched]``),
    training_step, on_train_epoch_end; no ``.to``."""

    def __init__(self):
        import torch
        torch.manual_seed(5)
        self.net = torch.nn.Linear(4, 1)
        self.epochs_ended = 0

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

    def configure_optimizers(self):
        import torch
        opt = torch.optim.SGD(self.net.parameters(), lr=0.05)
        sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1,
                                                gamma=0.9)
        return [opt], [sched]

    def training_step(self, batch, batch_idx):
        import torch
        x, y = batch
        return {"loss": torch.nn.functional.mse_loss(self.net(x), y)}

    def on_train_epoch_end(self):
        self.epochs_ended += 1


class LogValModule(ToyModule):
    """Adds ``self.log`` calls, the validation_step protocol, a skipped
    batch (``training_step`` returning None) and a step-interval scheduler
    in the dict form."""

    def configure_optimizers(self):
        import torch
        opt = torch.optim.SGD(self.net.parameters(), lr=0.05)
        sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1,
                                                gamma=0.97)
        return {"optimizer": opt,
                "lr_scheduler": {"scheduler": sched, "interval": "step",
                                 "frequency": 2}}

    def training_step(self, batch, batch_idx):
        if batch_idx == 1:
            return None
        out = super().training_step(batch, batch_idx)
        self.log("train_loss_logged", out["loss"])
        return out

    def validation_step(self, batch, batch_idx):
        import torch
        x, y = batch
        loss = torch.nn.functional.mse_loss(self.net(x), y)
        self.log("val_mae", (self.net(x) - y).abs().mean())
        return loss


def nn_toy_module():
    """An ``nn.Module`` that speaks the protocol (as a real LightningModule
    does), so the estimator's ``.to`` path runs."""
    import torch

    class Module(torch.nn.Module):
        def __init__(self):
            super().__init__()
            torch.manual_seed(5)
            self.net = torch.nn.Linear(4, 1)

        def forward(self, x):
            return self.net(x)

        def configure_optimizers(self):
            return torch.optim.SGD(self.parameters(), lr=0.05)

        def training_step(self, batch, batch_idx):
            x, y = batch
            return torch.nn.functional.mse_loss(self(x), y)
    return Module()


class FileRecorderCB:
    """Writes each hook it sees to ``path``; asserts the clip held at every
    step."""

    def __init__(self, path):
        self.path = path

    def _ev(self, s):
        with open(self.path, "a") as f:
            f.write(s + "\n")

    def on_train_start(self, trainer, module):
        self._ev(f"start {trainer.global_step}")

    def on_train_epoch_end(self, trainer, module):
        self._ev(f"epoch{trainer.current_epoch}")

    def on_train_batch_end(self, trainer, module, out, batch, i):
        import torch
        g = torch.sqrt(sum((p.grad ** 2).sum()
                           for p in module.parameters()
                           if p.grad is not None))
        # gradient_clip_val bounds the norm opt.step() saw
        assert float(g) <= CLIP + 1e-4, float(g)
        self._ev(f"batch {trainer.global_step} {float(g)!r}")

    def on_validation_epoch_end(self, trainer, module):
        assert "val_loss" in trainer.callback_metrics
        self._ev("val " + json.dumps(trainer.callback_metrics,
                                     sort_keys=True))

    def on_train_end(self, trainer, module):
        self._ev("end")


class StopAfter2CB:
    """EarlyStopping-style: writes ``trainer.should_stop``."""

    def on_train_epoch_end(self, trainer, module):
        if trainer.current_epoch >= 1:
            trainer.should_stop = True


class FileLogger:
    """The Lightning Logger protocol's subset, file-backed."""

    def __init__(self, path):
        self.path = path

    def log_metrics(self, metrics, step=None):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, "metrics": metrics}) + "\n")

    def finalize(self, status):
        with open(self.path, "a") as f:
            f.write('{"finalized": "%s"}\n' % status)
