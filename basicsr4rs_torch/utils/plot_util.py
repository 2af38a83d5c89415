"""Training curves from logs (counterpart of
``basicsr4rs_tpu/utils/plot_util.py``; reference: basicsr/utils/plot_util.py):
scalars of a TensorBoard event file (``tensorboard`` is imported at the
call), values scraped from a text log by a regular expression, and
TensorBoard's smoothing."""

from __future__ import annotations

import re


def read_data_from_tensorboard(log_path, tag):
    """(steps, values) of the scalar ``tag`` in a TensorBoard event file."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    event_acc = EventAccumulator(log_path)
    event_acc.Reload()
    print('tag list: ', event_acc.Tags()['scalars'])
    scalars = event_acc.Scalars(tag)
    return [int(s.step) for s in scalars], [s.value for s in scalars]


def read_data_from_txt_2v(path, pattern, step_one=False):
    """(steps, values) of the lines of a text log that ``pattern`` matches
    (group 1 the step, group 2 the value); ``step_one`` adds one to each
    step."""
    regex = re.compile(pattern)
    steps, values = [], []
    with open(path) as f:
        for line in f:
            match = regex.match(line.strip())
            if match:
                steps.append(int(match.group(1)))
                values.append(float(match.group(2)))
    if step_one:
        steps = [v + 1 for v in steps]
    return steps, values


def read_data_from_txt_1v(path, pattern):
    """The values (group 1) of the lines of a text log that ``pattern`` matches."""
    regex = re.compile(pattern)
    data = []
    with open(path) as f:
        for line in f:
            match = regex.match(line.strip())
            if match:
                data.append(float(match.group(1)))
    return data


def smooth_data(values, smooth_weight):
    """TensorBoard's smoothing: each value the running average
    ``last * w + (1 - w) * value``, from the first value."""
    out = []
    last = values[0]
    for value in values:
        last = last * smooth_weight + (1 - smooth_weight) * value
        out.append(last)
    return out
