"""Fault tolerance of the port's training: checkpoints and restarts."""
from repro_torch.ft.checkpoint import (AsyncCheckpointer, latest_checkpoint,
                                       list_checkpoints, restore_checkpoint,
                                       restore_latest, retain,
                                       save_checkpoint)
from repro_torch.ft.manager import (FailureInjector, PrefetchQueue,
                                    RestartManager, SimulatedFailure,
                                    elastic_remesh_plan)

__all__ = ["AsyncCheckpointer", "latest_checkpoint", "list_checkpoints",
           "restore_checkpoint", "restore_latest", "retain",
           "save_checkpoint", "FailureInjector", "PrefetchQueue",
           "RestartManager", "SimulatedFailure", "elastic_remesh_plan"]
