"""Batches of images through a classifier. The mix's ``feed``: ``device``
puts ``distinct`` batches on the device at set-up and classifies all of
them per ``map_batches`` call (one host sync a call); ``ring`` holds them
as pageable host arrays and serves a live generator that cycles them
through ``serve_ring`` until the window closes."""
import time

import numpy as np

from benchmark.common import drive, stats, traffic
from benchmark.common.harness import Record
from benchmark.common.trace import profiled


def warm(system, cell, seed, seconds):
    mix = cell.mix
    x = traffic.images(mix, seed, system.image_shape, system.device)
    with system.mode():
        if mix["feed"] == "device":
            for _ in range(2):
                system.model.map_batches([x])
            return {"x": x, "seed": seed}
        host = [x[i].cpu().numpy() for i in range(x.shape[0])]
        system.model.serve_ring(iter([[h] for h in host]), probe=False)
    return {"x": x, "host": host, "seed": seed}


def window(system, cell, state, seconds, profile_s):
    mix = cell.mix
    model, batch = system.model, int(mix["batch"])
    record = Record()
    untraced = seconds - profile_s
    with system.mode():
        if mix["feed"] == "device":
            x = state["x"]

            def stretch(length):
                outs, t0 = [], time.perf_counter()
                while True:
                    outs.append(model.map_batches([x])[0])
                    if time.perf_counter() - t0 >= length:
                        return outs, time.perf_counter() - t0
        else:
            host = state["host"]

            def stretch(length):
                t0 = time.perf_counter()
                end = t0 + length

                def feed():
                    i = 0
                    while time.perf_counter() < end:
                        yield [host[i % len(host)]]
                        i += 1

                outs = model.serve_ring(feed(), probe=False)
                return [o[0][None] for o in outs], \
                    time.perf_counter() - t0

        outs, wall = stretch(untraced)
        images = sum(o.shape[0] for o in outs) * batch
        record.window_s = wall
        record.attempted = images
        record.e2e["images_per_s"] = stats.rate(images, wall)
        record.stretch = {"images_per_s": images / wall, "seconds": wall}
        if profile_s > 0:
            def traced():
                more, _ = stretch(profile_s)
                return {"forward": sum(o.shape[0] for o in more)}
            record.trace = profiled(traced, drive.TRACE_PATH)
    # the check's sample: whole calls drawn from the seed; each output's
    # row j is distinct batch j (device feed) or batch i % distinct of the
    # ring's i-th output
    rng = np.random.default_rng(traffic.stream_seed(state["seed"], "check"))
    keep = drive.pick(rng, len(outs), int(mix["check_calls"]))
    distinct = state["x"].shape[0]
    sample = []
    for i in keep:
        o = outs[i]
        if mix["feed"] == "device":
            sample += [(j, o[j]) for j in range(o.shape[0])]
        else:
            sample.append((i % distinct, o[0]))
    record.sample = {"images": state["x"], "outputs": sample}
    return record
