"""In-process pipeline driver: chains StageEngines by direct calls (port of
``parallax_tpu/runtime/pipeline.py``, without the wire mode).

The ring: stage0 (head) -> ... -> stageN-1 -> head. Hidden states travel as
tensors on the stages' devices; sampled tokens (and a speculation round's
verified run, ``spec_accepted``) return to the head, which commits them.
"""

from __future__ import annotations

from parallax_tpu_torch.runtime.engine import StageEngine
from parallax_tpu_torch.runtime.request import Request


class InProcessPipeline:
    """Ring of engines: stage0 (head) -> ... -> stageN-1 -> head."""

    def __init__(self, engines: list[StageEngine]):
        assert engines and engines[0].model.is_first and engines[-1].model.is_last
        self.engines = engines
        self.finished: list[Request] = []

    @property
    def head(self) -> StageEngine:
        return self.engines[0]

    def submit(self, request: Request) -> bool:
        return self.head.submit(request)

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines)

    def step_round(self) -> list[Request]:
        """One step of every stage, routing packets around the ring."""
        newly_finished: list[Request] = []
        for i, engine in enumerate(self.engines):
            out = engine.step()
            for ireq in out.forward:
                if ireq.next_token_id is not None:
                    self.head.commit_token(
                        ireq.request_id, ireq.next_token_id,
                        ireq.token_logprob,
                    )
                elif ireq.spec_accepted is not None:
                    self.head.commit_spec_result(
                        ireq.request_id, ireq.spec_accepted)
                else:
                    self.engines[i + 1].submit_intermediate(ireq)
            for req in out.finished:
                newly_finished.append(req)
                aborted = req.status.value == "finished_abort"
                for other in self.engines:
                    if other is not engine:
                        other.release(req.request_id, abort=aborted)
        self.finished.extend(newly_finished)
        return newly_finished

    def run_until_complete(self, max_rounds: int = 10000) -> list[Request]:
        for _ in range(max_rounds):
            if not self.has_work():
                break
            self.step_round()
        return self.finished
