"""Host milliseconds a step inside ``Trainer.train_step``, from its span
``train.step`` less its wait for the staging buffer (``train.upload_wait``)."""

from portbench.harness import spans


def read(ctx):
    return spans.self_ms("train.step", lambda n: n == "train.upload_wait")
