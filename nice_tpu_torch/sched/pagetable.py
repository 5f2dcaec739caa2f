"""Fixed-size device pages over variable-size tenant fields (the port's
copy of nice_tpu/sched/pagetable.py).

The ragged-paging idea: tenants bring fields of arbitrary size, the device
wants fixed-shape dispatches. A page is a batch-aligned *segment quantum* —
``page_batches`` (default 4) loop segments of the owning tenant's tuned
``batch_size * segment`` shape (ops/engine.page_quantum) — so every page
boundary lands exactly on a segment boundary: a handoff between tenants
never splits a kernel launch, and switching tenants re-enters libraries
that are already built.

Each field's pages run in ascending order; per-page FieldResults fold into
the field accumulator (histogram counts add per num_uniques, nice numbers
concatenate and sort by number over disjoint sub-ranges), so the assembled
field result is byte-identical to one uninterrupted run. A preempted field
exports its accumulator in the engine's checkpoint-contract form, so the
standing crash-resume machinery (FieldCheckpointer + ``resume=``) carries
scheduler handoffs too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from nice_tpu_torch.core.types import (
    FieldResults,
    NiceNumberSimple,
    UniquesDistributionSimple,
)
from nice_tpu_torch.sched.tenants import TenantSpec

# Segments a page (the reference's NICE_TPU_SCHED_PAGE_BATCHES default).
PAGE_BATCHES_DEFAULT = 4


@dataclasses.dataclass(frozen=True)
class Page:
    """One fixed-quantum slice of one tenant's field: [start, end) with
    end - start a multiple of the tenant's segment quantum except for the
    field's final partial page."""

    tenant: str
    field_key: str
    base: int
    start: int
    end: int
    seq: int

    @property
    def size(self) -> int:
        return self.end - self.start


class FieldWork:
    """One field's pages plus its fold accumulator."""

    def __init__(self, spec: TenantSpec, field_key: str, base: int,
                 start: int, end: int, pages: list[Page]):
        self.spec = spec
        self.field_key = field_key
        self.base = base
        self.start = start
        self.end = end
        self.pages = pages
        self.next_page = 0
        # Histogram bins 0..base+1, matching the engine's checkpoint hist.
        self._hist = np.zeros(base + 2, dtype=np.int64)
        self._nice: list[NiceNumberSimple] = []
        self.cursor = start  # first number NOT yet folded

    @property
    def done(self) -> bool:
        return self.next_page >= len(self.pages)

    def peek_page(self) -> Optional[Page]:
        return None if self.done else self.pages[self.next_page]

    def fold(self, page: Page, results: FieldResults) -> None:
        """Fold one executed page. Pages must arrive in order — the
        accumulator is a prefix of the field."""
        if self.done or page is not self.pages[self.next_page]:
            raise ValueError(
                f"page {page.seq} folded out of order for {self.field_key}"
            )
        for row in results.distribution:
            self._hist[row.num_uniques] += row.count
        self._nice.extend(results.nice_numbers)
        self.next_page += 1
        self.cursor = page.end

    def result(self) -> FieldResults:
        """The assembled field result, byte-identical to one uninterrupted
        engine run: detailed distributions are the 1..base rows of the
        summed histogram; nice numbers sort by value (sub-ranges are
        disjoint, so there are no ties to break)."""
        if not self.done:
            raise ValueError(f"field {self.field_key} still has pages")
        if self.spec.mode == "detailed":
            dist = tuple(
                UniquesDistributionSimple(num_uniques=i, count=int(self._hist[i]))
                for i in range(1, self.base + 1)
            )
        else:
            dist = ()
        nice = tuple(sorted(self._nice, key=lambda x: x.number))
        return FieldResults(distribution=dist, nice_numbers=nice)

    def resume_state(self) -> dict:
        """The accumulator in the engine's checkpoint-contract form: feed
        it to ``process_range_detailed/niceonly(resume=...)`` (or persist
        it through ckpt.FieldCheckpointer) and the field completes byte-
        identically from the preemption point. "filtered" is False: the
        remaining range has not been through the MSD filter."""
        return {
            "cursor": self.cursor,
            "hist": self._hist.copy() if self.spec.mode == "detailed" else None,
            "nice_numbers": [(n.number, n.num_uniques) for n in self._nice],
            "remaining": (
                [] if self.cursor >= self.end else [[self.cursor, self.end]]
            ),
            "filtered": False,
        }


class PageTable:
    """Packs tenant fields into pages and tracks per-tenant page queues.
    ``device`` is the one the pages run on: the tuned shape, and so the
    quantum, is a (mode, base, device type) winner."""

    def __init__(self, page_batches: int = PAGE_BATCHES_DEFAULT,
                 device="cuda"):
        if page_batches < 1:
            raise ValueError(f"page_batches must be at least 1, got"
                             f" {page_batches}")
        self.page_batches = page_batches
        self.device = device
        self._fields: dict[str, FieldWork] = {}
        # Per-tenant FIFO of field keys with pages left.
        self._queues: dict[str, list[str]] = {}

    def quantum_for(self, spec: TenantSpec, base: Optional[int] = None) -> int:
        """Page size in numbers for one tenant workload: page_batches
        segment quanta of the tenant's OWN tuned shape (resolve_tuning per
        tenant, not per process)."""
        from nice_tpu_torch.ops import engine

        return self.page_batches * engine.page_quantum(
            spec.mode, base if base is not None else spec.base,
            device=self.device, backend=spec.backend,
            batch_size=spec.batch_size,
        )

    def add_field(self, spec: TenantSpec, field_key: str, base: int,
                  start: int, end: int) -> FieldWork:
        if end <= start:
            raise ValueError(f"empty field {field_key}: [{start}, {end})")
        if field_key in self._fields:
            raise ValueError(f"field {field_key} already paged")
        quantum = self.quantum_for(spec, base)
        pages = []
        cursor = start
        seq = 0
        while cursor < end:
            page_end = min(cursor + quantum, end)
            pages.append(Page(
                tenant=spec.name, field_key=field_key, base=base,
                start=cursor, end=page_end, seq=seq,
            ))
            cursor = page_end
            seq += 1
        work = FieldWork(spec, field_key, base, start, end, pages)
        self._fields[field_key] = work
        self._queues.setdefault(spec.name, []).append(field_key)
        return work

    def has_pages(self, tenant: str) -> bool:
        return bool(self._queues.get(tenant))

    def pending_pages(self, tenant: str) -> int:
        return sum(
            len(self._fields[k].pages) - self._fields[k].next_page
            for k in self._queues.get(tenant, ())
        )

    def next_page(self, tenant: str) -> Optional[tuple[FieldWork, Page]]:
        """The tenant's next page (front field, ascending page order), or
        None when the tenant has no queued work."""
        queue = self._queues.get(tenant)
        if not queue:
            return None
        work = self._fields[queue[0]]
        page = work.peek_page()
        if page is None:  # defensive: drained fields leave the queue in fold
            queue.pop(0)
            return self.next_page(tenant)
        return work, page

    def fold(self, work: FieldWork, page: Page,
             results: FieldResults) -> bool:
        """Fold an executed page; returns True when its field just
        drained (and left the tenant queue)."""
        work.fold(page, results)
        if work.done:
            self._queues[work.spec.name].remove(work.field_key)
            return True
        return False

    def field(self, field_key: str) -> FieldWork:
        return self._fields[field_key]

    def check_invariants(self) -> list[str]:
        """Packing invariants, as violation strings (tests assert empty):
        pages of a field are contiguous, non-overlapping, cover [start,
        end) exactly, carry one (tenant, base) — one limb plan — per page
        list, and only the final page may be quantum-short."""
        problems = []
        for key, work in self._fields.items():
            if not work.pages:
                problems.append(f"{key}: no pages")
                continue
            quantum = self.quantum_for(work.spec, work.base)
            cursor = work.start
            for page in work.pages:
                if page.start != cursor:
                    problems.append(
                        f"{key} page {page.seq}: starts at {page.start},"
                        f" expected {cursor} (gap/overlap)"
                    )
                if page.tenant != work.spec.name or page.base != work.base:
                    problems.append(
                        f"{key} page {page.seq}: crosses limb plans"
                        f" ({page.tenant}/{page.base} in a"
                        f" {work.spec.name}/{work.base} field)"
                    )
                if page.size != quantum and page is not work.pages[-1]:
                    problems.append(
                        f"{key} page {page.seq}: interior page of size"
                        f" {page.size}, quantum {quantum}"
                    )
                if page.size <= 0 or page.size > quantum:
                    problems.append(
                        f"{key} page {page.seq}: size {page.size} outside"
                        f" (0, {quantum}]"
                    )
                cursor = page.end
            if cursor != work.end:
                problems.append(
                    f"{key}: pages end at {cursor}, field ends at {work.end}"
                )
        return problems
