"""Experiment-configuration helpers shared by the port's CLIs.

The port's copy of the task-name resolution of
multitalent_tpu/cli/configuration.py:19-23 (that module imports the JAX
package's trainer registry). The folder naming it feeds is
RESULTS/nnUNet/<network>/<task>/<trainer>__<plans_identifier>.
"""
from __future__ import annotations

from multitalent_tpu_torch.utils.task_names import convert_id_to_task_name


def resolve_task_name(task: str) -> str:
    """Accept 'TaskXXX_name' or a bare integer id."""
    if task.startswith("Task"):
        return task
    return convert_id_to_task_name(int(task))
