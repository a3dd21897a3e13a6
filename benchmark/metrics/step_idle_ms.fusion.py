"""``step_idle_ms.train`` read in the stage-3 fusion's train cells, where it moves
``fusion_train_samples_per_s``."""

from benchmark.lib import readers

read = readers.same_as("step_idle_ms.train")
