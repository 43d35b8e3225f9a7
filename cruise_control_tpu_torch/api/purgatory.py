"""Two-step verification purgatory for POST requests.

Counterpart of ``cruise_control_tpu/api/purgatory.py`` (host code, copied).

Parity with ``Purgatory`` (servlet/purgatory/Purgatory.java:43 and the
2-step-verification wiki doc): when enabled, mutating POST requests park as
``PENDING_REVIEW``; an admin reviews via ``/review`` (approve/discard);
re-submitting the original request with ``review_id`` executes an APPROVED
request exactly once (→ SUBMITTED).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple


class ReviewStatus:
    PENDING_REVIEW = "PENDING_REVIEW"
    APPROVED = "APPROVED"
    SUBMITTED = "SUBMITTED"
    DISCARDED = "DISCARDED"


@dataclasses.dataclass
class ReviewRequest:
    review_id: int
    endpoint: str
    query: Dict[str, str]
    status: str
    submitted_ms: int
    reason: str = ""

    def to_dict(self) -> Dict[str, object]:
        return {"Id": self.review_id, "EndPoint": self.endpoint,
                "Query": dict(self.query), "Status": self.status,
                "SubmittedMs": self.submitted_ms, "Reason": self.reason}


class Purgatory:
    def __init__(self, retention_ms: int = 7 * 24 * 3600 * 1000,
                 max_requests: int = 25):
        # two.step.purgatory.{retention.time.ms,max.requests}
        # (WebServerConfig): expiry of reviewed requests + a cap on parked
        # pending reviews.
        self._lock = threading.Lock()
        self._requests: Dict[int, ReviewRequest] = {}  # guarded-by: _lock
        self._next_id = 0  # guarded-by: _lock
        self._retention_ms = retention_ms
        self._max_requests = max_requests

    def add(self, endpoint: str, query: Dict[str, str]) -> ReviewRequest:
        with self._lock:
            self._gc()
            pending = sum(1 for r in self._requests.values()
                          if r.status == ReviewStatus.PENDING_REVIEW)
            if pending >= self._max_requests:
                raise ValueError(
                    f"two-step purgatory is full ({pending} pending reviews >= "
                    f"two.step.purgatory.max.requests={self._max_requests})")
            req = ReviewRequest(self._next_id, endpoint, dict(query),
                                ReviewStatus.PENDING_REVIEW,
                                int(time.time() * 1000))
            self._requests[self._next_id] = req
            self._next_id += 1
            return req

    def _gc(self) -> None:  # holds-lock: _lock
        now = int(time.time() * 1000)
        for rid in [r for r, req in self._requests.items()
                    if now - req.submitted_ms > self._retention_ms]:
            del self._requests[rid]

    def review(self, approve_ids: Tuple[int, ...] = (),
               discard_ids: Tuple[int, ...] = (), reason: str = "") -> List[Dict]:
        with self._lock:
            for rid in approve_ids:
                req = self._requests.get(rid)
                if req and req.status == ReviewStatus.PENDING_REVIEW:
                    req.status = ReviewStatus.APPROVED
                    req.reason = reason
            for rid in discard_ids:
                req = self._requests.get(rid)
                if req and req.status in (ReviewStatus.PENDING_REVIEW,
                                          ReviewStatus.APPROVED):
                    req.status = ReviewStatus.DISCARDED
                    req.reason = reason
            return [r.to_dict() for r in self._requests.values()]

    def take_approved(self, review_id: int, endpoint: str) -> ReviewRequest:
        """Claim an APPROVED request for execution (→ SUBMITTED); raises on
        wrong endpoint/state (Purgatory.submit semantics)."""
        with self._lock:
            req = self._requests.get(review_id)
            if req is None:
                raise KeyError(f"unknown review id {review_id}")
            if req.endpoint != endpoint:
                raise ValueError(f"review {review_id} is for {req.endpoint}, "
                                 f"not {endpoint}")
            if req.status != ReviewStatus.APPROVED:
                raise ValueError(f"review {review_id} is {req.status}, not APPROVED")
            req.status = ReviewStatus.SUBMITTED
            return req

    def board(self) -> List[Dict[str, object]]:
        with self._lock:
            self._gc()
            return [r.to_dict() for r in
                    sorted(self._requests.values(), key=lambda r: r.review_id)]
