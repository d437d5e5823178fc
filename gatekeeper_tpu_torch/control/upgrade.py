"""Storage-version upgrade manager.

Counterpart of the reference pkg/upgrade/manager.go:80-158: a one-shot
pass at startup that touches every v1alpha1 constraint and template (a
no-op update) so the apiserver rewrites them at the current storage
version (v1beta1).
"""

from __future__ import annotations

from .kube import KubeError
from .logging import logger

log = logger("upgrade")

TEMPLATE_GVK = ("templates.gatekeeper.sh", "v1beta1", "ConstraintTemplate")
CONSTRAINT_GROUP = "constraints.gatekeeper.sh"


class UpgradeManager:
    def __init__(self, kube):
        self.kube = kube

    def upgrade(self) -> int:
        """Touch templates + all constraint kinds; returns objects touched."""
        touched = 0
        kinds = [TEMPLATE_GVK]
        try:
            for res in self.kube.server_preferred_resources():
                if res.get("group") == CONSTRAINT_GROUP:
                    kinds.append((res["group"], res["version"], res["kind"]))
        except KubeError:
            pass
        for gvk in kinds:
            try:
                objs = self.kube.list(gvk)
            except KubeError:
                continue
            for obj in objs:
                try:
                    self.kube.update(obj)
                    touched += 1
                except KubeError:
                    continue
        if touched:
            log.info("storage-version upgrade complete",
                     details={"objects": touched})
        return touched
