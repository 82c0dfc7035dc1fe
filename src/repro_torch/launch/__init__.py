"""The production step functions (port of ``repro.launch``): the Bayes
train state, the train round (eq. (6) + one Bayes-by-Backprop step on the
LM objective), the local and consensus steps that ``api.LaunchEngine`` and
``launch.train`` drive; the model zoo's serving steps
(``steps.init_train_state``, ``serve_params``, ``make_prefill_step``,
``make_decode_step``, ``make_agent_cache``); the sharded consensus
(``consensus_opt``) over the meshes (``mesh``), the sharding rules and
block placement (``sharding``), the expert-parallel MoE
(``expert_parallel``), placed trees and their collectives (``spmd``) and
the LM steps on placed inputs (``spmd_steps``); the cost model
(``costmodel``) and the dry run (``dryrun``).  The entry points ``launch.train``, ``launch.serve`` and
``launch.dryrun`` are submodules this package does not import; it imports
without the model zoo, which the LM steps import when they are called."""
from repro_torch.launch.steps import (
    BayesTrainState,
    make_consensus_step,
    make_local_step,
    make_train_round_step,
)

__all__ = ["BayesTrainState", "make_consensus_step", "make_local_step", "make_train_round_step"]
