"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``):
``Speedometer``, ``do_checkpoint``, ``log_train_metric``,
``ProgressBar``.  Plain Python: the port's own copy.
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric", "ProgressBar"]


class Speedometer:
    """Log training speed and metrics every ``frequent`` batches
    (as callback.py Speedometer)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0.0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / (
                    time.time() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s"
                    logging.info(msg, param.epoch, count, speed,
                                 "\t".join(f"{n}={v:f}"
                                           for n, v in name_value))
                else:
                    logging.info(
                        "Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                        param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class BatchEndParam:
    """Carries state to callbacks (as model.py BatchEndParam)."""

    def __init__(self, epoch=0, nbatch=0, eval_metric=None, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving block parameters (as
    callback.py do_checkpoint; gluon-era: saves via save_parameters)."""
    period = int(max(1, period))

    def _callback(epoch, net, *args):
        if (epoch + 1) % period == 0:
            fname = f"{prefix}-{epoch + 1:04d}.params"
            net.save_parameters(fname)
            logging.info("Saved checkpoint to \"%s\"", fname)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Log evaluation metric every ``period`` batches (as
    callback.py log_train_metric)."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class ProgressBar:
    """Text progress bar (as callback.py ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s", prog_bar, percents, "%")
