"""The production step functions (port of ``repro.launch``): the Bayes
train state and the local and consensus steps that ``api.LaunchEngine``
drives; the sharded consensus (``consensus_opt``) over the agent mesh
(``mesh``); the cost model (``costmodel``).  The language-model branches,
the sharding rules and the model zoo come with ROADMAP queue A item 10;
this package imports without them."""
from repro_torch.launch.steps import BayesTrainState, make_consensus_step, make_local_step

__all__ = ["BayesTrainState", "make_consensus_step", "make_local_step"]
