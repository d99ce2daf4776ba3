"""Evaluator (counterpart of ``bigdl_tpu.optim.evaluator``; BigDL
optim/Evaluator.scala:37): the local path.

``Evaluator(model).test(dataset, methods)`` runs the Predictor's sweep
and scores each batch's host copy with every method, summing the
results over batches.

Not ported yet: the mesh path, its cross-process reduce and its
device-cached sweep (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.optim.predictor import Predictor
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult)

__all__ = ["Evaluator"]


class Evaluator(Predictor):
    def results(self, dataset, methods: Sequence[ValidationMethod],
                batch_size: int = 32) -> Optional[List[ValidationResult]]:
        """Each method's result summed over the batches, in the methods'
        order (None for an empty dataset): the sweep the driver's
        validation also runs."""
        results = None
        for out, b in self.outputs(dataset, batch_size):
            tgt = np.asarray(b.get_target())
            batch_res = [m(out, tgt) for m in methods]
            results = batch_res if results is None \
                else [r + br for r, br in zip(results, batch_res)]
        return results

    def test(self, dataset, methods: Sequence[ValidationMethod],
             batch_size: int = 32) -> Dict[str, ValidationResult]:
        """``{method name: summed result}``; empty for an empty
        dataset."""
        results = self.results(dataset, methods, batch_size)
        if results is None:
            return {}
        return {m.name: r for m, r in zip(methods, results)}
