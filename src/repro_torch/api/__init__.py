"""``repro_torch.api`` — the declarative front door.

    from repro_torch.api import (
        DataSpec, ExperimentSpec, InferenceSpec, RunSpec, TopologySpec,
        build_session,
    )

    session = build_session(spec)   # on the CUDA card; device="cpu" to opt out
    session.run()
    print(session.evaluate(), session.health())

``TopologySpec.gossip(base, params, clock=...)`` selects the event-driven
asynchronous ``GossipEngine`` (``repro_torch.gossip``): one event window per
round, telemetry under ``evaluate()["engine"]``.
``InferenceSpec(method="conjugate_linreg")`` runs paper Example 1 on the
``ConjugateLinregEngine``.  ``session.save(path)`` / ``Session.load(path)``
write and read the JAX package's checkpoint documents.
"""
from repro_torch.api.data import DataBundle, build_data
from repro_torch.api.engines import ConjugateLinregEngine, Engine, LaunchEngine, SimulatedEngine
from repro_torch.api.models import MODELS, ModelFns, build_model, mlp_init, mlp_logits, mlp_nll
from repro_torch.api.session import Session, build_session
from repro_torch.api.spec import (
    DataSpec,
    ExperimentSpec,
    InferenceSpec,
    ObsSpec,
    RunSpec,
    ServeSpec,
    TopologySpec,
)
from repro_torch.gossip.engine import GossipEngine

__all__ = [
    "ConjugateLinregEngine",
    "DataBundle",
    "DataSpec",
    "Engine",
    "ExperimentSpec",
    "GossipEngine",
    "InferenceSpec",
    "LaunchEngine",
    "MODELS",
    "ModelFns",
    "ObsSpec",
    "RunSpec",
    "ServeSpec",
    "Session",
    "SimulatedEngine",
    "TopologySpec",
    "build_data",
    "build_model",
    "build_session",
    "mlp_init",
    "mlp_logits",
    "mlp_nll",
]
