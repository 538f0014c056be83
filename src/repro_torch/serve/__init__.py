"""Serving of the port: the continuous-batching engine and the v2 API.

``ServeEngine`` (the synchronous baseline) and the multi-engine front-ends
are not ported yet; constructing them raises and names the ROADMAP.md
item that ports them.
"""
from repro_torch.serve.api import (
    GenerationRequest, RequestHandle, RequestOutput, SamplingParams,
)
from repro_torch.serve.batch import (
    BlockPool, PagedSlotManager, Slot, SlotManager,
)
from repro_torch.serve.engine import ContinuousBatchingEngine, prompt_bucket
from repro_torch.serve.scheduler import RequestQueue, poisson_arrivals


class _NotPorted:
    _item = ""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported; see ROADMAP.md "
            f"{self._item}")


class ServeEngine(_NotPorted):
    _item = "queue 1, item 12 (benchmarks and the synchronous baseline)"


class ClusterFrontEnd(_NotPorted):
    _item = "queue 1, item 11 (cluster and the TCP scheduler)"


class ProcClusterFrontEnd(_NotPorted):
    _item = "queue 1, item 11 (cluster and the TCP scheduler)"
