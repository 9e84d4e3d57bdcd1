"""The engine's step (utils/serving.py ContinuousBatcher.step, ending in
its own device-to-host read) on the host clock: the untraced stretch's
step seconds over its step calls, in the batch cell."""


def read(run):
    return run.record.stretch.get("step_ms") or None
