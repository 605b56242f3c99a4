"""The share of each frame of ``DetectModule.process`` (the benchmark's span
``bench/frame``) spent outside the predict function the benchmark hands
to ``DetectModule.set_model`` (its span ``bench/predict``): frame
parsing, accumulation, the fetch, freespace, the tracker and the filter."""


def read(run):
    if run.trace is None:
        return None
    frame = run.trace.span_s("bench/frame")
    if frame <= 0:
        return None
    return 100.0 * (1.0 - run.trace.span_s("bench/predict") / frame)
