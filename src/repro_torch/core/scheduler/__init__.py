from repro_torch.core.scheduler.global_controller import (AdmissionDecision,
                                                    AdmissionPolicy,
                                                    ControllerEvent,
                                                    GlobalController,
                                                    ModelCost, NodeHandle)
from repro_torch.core.scheduler.hybrid_scheduler import (HybridScheduler,
                                                   ScheduleDecision)
from repro_torch.core.scheduler.load_score import (DECODE_WEIGHTS, PREFILL_WEIGHTS,
                                             ScoreWeights, Thresholds,
                                             classify_regime, cluster_scores,
                                             node_score)
from repro_torch.core.scheduler.metrics import NodeStatus, SlidingWindow, normalize

__all__ = [
    "AdmissionDecision", "AdmissionPolicy", "ControllerEvent",
    "GlobalController", "ModelCost", "NodeHandle",
    "HybridScheduler", "ScheduleDecision", "ScoreWeights", "Thresholds",
    "classify_regime", "cluster_scores", "node_score", "NodeStatus",
    "SlidingWindow", "normalize", "PREFILL_WEIGHTS", "DECODE_WEIGHTS",
]
