"""Scene-graph nodes as views over the entity hierarchy.

The reference engine mirrors the transform hierarchy into per-entity
``CKSceneGraphNode`` objects owned by the render manager, for render order
and culling (include/CKSceneGraph.h:38-107, src/CKSceneGraph.cpp). This
package keeps the hierarchy in the flat entity table, so a node is a view:
it reads the live entity hierarchy and offers the node API
(priority-sorted children, render-context masks, hierarchical boxes, a
time-profiler slot) without owning any state the frame needs.
"""

from __future__ import annotations

import numpy as np


class CKSceneGraphNode:
    """View of one entity's place in the render hierarchy."""

    def __init__(self, manager, entity=None):
        self._manager = manager
        self.entity = entity
        self.time_profiler_ms = 0.0

    def GetEntity(self):
        return self.entity

    def GetPriority(self) -> int:
        return self.entity.render_priority if self.entity is not None else 0

    def SetPriority(self, p: int, _context=None):
        if self.entity is not None:
            self.entity.SetRenderPriority(p)

    def _child_entities(self) -> list:
        """The children, high priority first, then by creation (the scene
        compile's order; src/CKSceneGraph.cpp:495-529 keeps them sorted
        by priority). The root's children are the parentless 3D
        entities."""
        if self.entity is None:
            from ..objects.entity import CK3dEntity

            ents = [o for o in self._manager.context._objects.values()
                    if isinstance(o, CK3dEntity) and o.GetParent() is None]
        else:
            ents = list(self.entity._children)
        ents.sort(key=lambda e: (-e.render_priority, e.id))
        return ents

    def GetChildrenCount(self) -> int:
        return len(self._child_entities())

    def GetChild(self, i: int) -> "CKSceneGraphNode":
        return CKSceneGraphNode(self._manager, self._child_entities()[i])

    def GetRenderContextMask(self) -> int:
        ent = self.entity
        return int(ent._in_render_context_mask) if ent is not None else ~0

    def SetRenderContextMask(self, mask: int):
        if self.entity is not None:
            self.entity._in_render_context_mask = int(mask)

    def IsToBeParsed(self) -> bool:
        """Visible, or with children that could be
        (src/CKSceneGraph.cpp:379-432)."""
        if self.entity is None:
            return True
        return self.entity.IsVisible() or self.GetChildrenCount() > 0

    def ComputeHierarchicalBox(self):
        """World box (min, max) of the entity and all its descendants, or
        None (src/CKSceneGraph.cpp:849-888)."""
        lo = np.full(3, np.inf, np.float32)
        hi = np.full(3, -np.inf, np.float32)

        def visit(ent):
            nonlocal lo, hi
            box = ent.GetBoundingBox()
            if box is not None:
                lo = np.minimum(lo, box[0])
                hi = np.maximum(hi, box[1])
            for c in ent._children:
                visit(c)

        if self.entity is not None:
            visit(self.entity)
        else:
            for e in self._child_entities():
                sub = CKSceneGraphNode(self._manager,
                                       e).ComputeHierarchicalBox()
                if sub is not None:
                    lo = np.minimum(lo, sub[0])
                    hi = np.maximum(hi, sub[1])
        if not np.isfinite(lo).all():
            return None
        return lo, hi


class CKSceneGraphRootNode(CKSceneGraphNode):
    """The manager's root node: its children are the parentless entities.
    Transparent objects are ordered by the frame's sort keys, so the root
    offers only the traversal API."""

    def __init__(self, manager):
        super().__init__(manager, None)

    def AddTransparentObject(self, ent):
        """Nothing to record: the frame sorts transparent triangles."""

    def SortNodes(self):
        """Nothing to sort: children are sorted when read."""
