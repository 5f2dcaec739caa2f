"""nice_tpu_torch.sched — the multi-tenant ragged scheduler: pack
heterogeneous (mode, base) workloads onto one device (the port's copy of
nice_tpu/sched).

Layering: sched sits above ops/engine (pages run through the ordinary
process_range_* entry points, so checkpoint-contract resume and the tuned
shapes apply unchanged) and above parallel/mesh (occupancy accounting);
obs provides the per-tenant SLO burn feedback. Nothing else in the package
imports sched — the client opts in with --tenants, and the server only
sees the tenant name on claim rows.
"""

from nice_tpu_torch.sched.pagetable import FieldWork, Page, PageTable
from nice_tpu_torch.sched.scheduler import MultiTenantScheduler
from nice_tpu_torch.sched.source import ServerSource, StaticSource
from nice_tpu_torch.sched.tenants import (
    TenantRegistry,
    TenantSpec,
    hi_base_sweep_tenant,
    near_miss_tenant,
    parse_tenants,
)

__all__ = [
    "FieldWork",
    "Page",
    "PageTable",
    "MultiTenantScheduler",
    "ServerSource",
    "StaticSource",
    "TenantRegistry",
    "TenantSpec",
    "hi_base_sweep_tenant",
    "near_miss_tenant",
    "parse_tenants",
]
