"""Git-like semantics for data: branches, commits, merges, ephemeral runs.

Faithful to the paper's workflow (4.3, Fig. 4):

1. user works on a code branch ``feat_1`` → catalog branch ``feat_1`` is
   created from ``main``;
2. each ``run`` executes in an **ephemeral branch** (``run_<id>``) forked
   from the working branch;
3. only if every step and every expectation succeeds is the ephemeral
   branch **merged** back (atomic, transaction-like); otherwise it is
   discarded and production data is never dirtied;
4. the ephemeral branch is deleted after the merge.

Commits are immutable content-addressed objects in the ObjectStore;
branch heads are CAS-updated refs, so concurrent writers cannot silently
clobber each other (optimistic concurrency, like Nessie).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.io.objectstore import ObjectStore
from repro_torch.io.serialization import dumps_json, loads_json
from repro_torch.utils.hashing import stable_hash

_BRANCH_NS = "branches"
_TAG_NS = "tags"


class CatalogError(RuntimeError):
    pass


class MergeConflict(CatalogError):
    """Raised when both branches changed the same table since their base."""


@dataclass(frozen=True)
class Commit:
    """An immutable catalog state: {table name -> snapshot manifest key}."""

    commit_id: str
    parent_id: Optional[str]
    tables: Dict[str, str]
    message: str
    author: str
    created_at: float
    extra_parent_id: Optional[str] = None  # for merge commits

    def to_json_dict(self) -> Dict:
        return {
            "commit_id": self.commit_id,
            "parent_id": self.parent_id,
            "tables": self.tables,
            "message": self.message,
            "author": self.author,
            "created_at": self.created_at,
            "extra_parent_id": self.extra_parent_id,
        }

    @staticmethod
    def from_json_dict(d: Dict) -> "Commit":
        return Commit(
            commit_id=d["commit_id"],
            parent_id=d.get("parent_id"),
            tables=dict(d["tables"]),
            message=d.get("message", ""),
            author=d.get("author", ""),
            created_at=d.get("created_at", 0.0),
            extra_parent_id=d.get("extra_parent_id"),
        )


@dataclass
class Catalog:
    store: ObjectStore
    default_branch: str = "main"

    def __post_init__(self) -> None:
        if self.store.get_ref(_BRANCH_NS, self.default_branch) is None:
            root = self._write_commit(
                parent_id=None, tables={}, message="init", author="system"
            )
            self.store.set_ref(_BRANCH_NS, self.default_branch, {"commit": root.commit_id})

    # -------------------------------------------------------------- commits
    def _write_commit(
        self,
        *,
        parent_id: Optional[str],
        tables: Dict[str, str],
        message: str,
        author: str,
        extra_parent_id: Optional[str] = None,
    ) -> Commit:
        created = time.time()
        commit_id = stable_hash(
            {
                "parent": parent_id,
                "tables": tables,
                "message": message,
                "author": author,
                "created": created,
                "extra": extra_parent_id,
            },
            length=32,
        )
        commit = Commit(commit_id, parent_id, dict(tables), message, author,
                        created, extra_parent_id)
        self.store.set_ref("commits", commit_id, commit.to_json_dict())
        return commit

    def get_commit(self, commit_id: str) -> Commit:
        raw = self.store.get_ref("commits", commit_id)
        if raw is None:
            raise CatalogError(f"no such commit {commit_id}")
        return Commit.from_json_dict(raw)

    def get_commit_opt(self, commit_id: Optional[str]) -> Optional[Commit]:
        """Like ``get_commit`` but None for a missing/expired commit.

        After ``repro gc`` expires old history, a surviving commit's
        parent pointer may dangle; walks treat that as the history
        horizon (like a shallow git clone) rather than corruption.
        """
        if commit_id is None:
            return None
        raw = self.store.get_ref("commits", commit_id)
        return None if raw is None else Commit.from_json_dict(raw)

    def delete_commit(self, commit_id: str) -> bool:
        """Remove a commit ref (GC of expired/unreachable history)."""
        return self.store.delete_ref("commits", commit_id)

    def all_commit_ids(self) -> List[str]:
        """Every commit ref in the store, reachable or not."""
        return sorted(self.store.list_refs("commits").keys())

    # ------------------------------------------------------------- branches
    def branches(self) -> List[str]:
        return sorted(self.store.list_refs(_BRANCH_NS).keys())

    def head(self, branch: str) -> Commit:
        ref = self.store.get_ref(_BRANCH_NS, branch)
        if ref is None:
            raise CatalogError(f"no such branch {branch!r}")
        return self.get_commit(ref["commit"])

    def create_branch(
        self,
        name: str,
        *,
        from_branch: Optional[str] = None,
        at_commit: Optional[str] = None,
    ) -> Commit:
        """Fork a branch from another branch's head or any commit
        (``at_commit`` enables replaying runs against historical data)."""
        if self.store.get_ref(_BRANCH_NS, name) is not None:
            raise CatalogError(f"branch {name!r} already exists")
        base = (
            self.get_commit(at_commit)
            if at_commit is not None
            else self.head(from_branch or self.default_branch)
        )
        self.store.set_ref(_BRANCH_NS, name, {"commit": base.commit_id})
        return base

    def delete_branch(self, name: str) -> None:
        if name == self.default_branch:
            raise CatalogError("refusing to delete the default branch")
        self.store.delete_ref(_BRANCH_NS, name)

    def has_branch(self, name: str) -> bool:
        return self.store.get_ref(_BRANCH_NS, name) is not None

    # -------------------------------------------------------------- writing
    def commit(
        self,
        branch: str,
        updates: Dict[str, Optional[str]],
        *,
        message: str = "",
        author: str = "user",
        expect: Optional[Dict[str, Optional[str]]] = None,
    ) -> Commit:
        """Commit table updates to a branch (``None`` value deletes a table).

        Uses CAS on the branch head: concurrent commits retry against the
        fresh head, so a lost-update can't happen (optimistic concurrency).

        ``expect`` maps table name -> the snapshot key the caller derived
        its update *from*; if the fresh head disagrees, ``MergeConflict``
        is raised instead of silently overwriting a concurrent change.
        Derived rewrites (e.g. compaction) need this: their update is only
        valid against the exact version they read.
        """
        for _ in range(64):
            ref = self.store.get_ref(_BRANCH_NS, branch)
            if ref is None:
                raise CatalogError(f"no such branch {branch!r}")
            head = self.get_commit(ref["commit"])
            if expect is not None:
                for name, key in expect.items():
                    if head.tables.get(name) != key:
                        raise MergeConflict(
                            f"table {name!r} changed concurrently on "
                            f"{branch!r} (expected {key!r})"
                        )
            tables = dict(head.tables)
            for name, key in updates.items():
                if key is None:
                    tables.pop(name, None)
                else:
                    tables[name] = key
            commit = self._write_commit(
                parent_id=head.commit_id, tables=tables, message=message, author=author
            )
            if self.store.compare_and_set_ref(
                _BRANCH_NS, branch, ref, {"commit": commit.commit_id}
            ):
                return commit
        raise CatalogError(f"commit contention on branch {branch!r}")

    # -------------------------------------------------------------- reading
    def table_key(self, name: str, *, branch: Optional[str] = None,
                  commit_id: Optional[str] = None) -> str:
        """Resolve a logical table name to a snapshot manifest key.

        ``commit_id`` gives time travel to any historical commit.
        """
        commit = (
            self.get_commit(commit_id)
            if commit_id is not None
            else self.head(branch or self.default_branch)
        )
        if name not in commit.tables:
            where = commit_id or branch or self.default_branch
            raise CatalogError(f"table {name!r} not found at {where!r}")
        return commit.tables[name]

    def tables(self, *, branch: Optional[str] = None) -> Dict[str, str]:
        return dict(self.head(branch or self.default_branch).tables)

    def log(self, branch: str, *, limit: int = 50) -> List[Commit]:
        out, cur = [], self.head(branch)
        while cur is not None and len(out) < limit:
            out.append(cur)
            # stop at the history horizon (parent expired by gc)
            cur = self.get_commit_opt(cur.parent_id)
        return out

    # -------------------------------------------------------------- merging
    def _ancestors(self, commit_id: str) -> List[str]:
        """Commit ids reachable from ``commit_id``, horizon-tolerant."""
        seen: List[str] = []
        stack = [commit_id]
        while stack:
            cid = stack.pop()
            if cid in seen:
                continue
            c = self.get_commit_opt(cid)
            if c is None:  # expired by gc — history ends here
                continue
            seen.append(cid)
            if c.parent_id:
                stack.append(c.parent_id)
            if c.extra_parent_id:
                stack.append(c.extra_parent_id)
        return seen

    def merge_base(self, a: str, b: str) -> Optional[str]:
        ancestors_a = self._ancestors(a)
        set_a = set(ancestors_a)
        # BFS from b in order — first hit is the nearest common ancestor.
        stack = [b]
        visited = set()
        while stack:
            cid = stack.pop(0)
            if cid in set_a:
                return cid
            if cid in visited:
                continue
            visited.add(cid)
            c = self.get_commit_opt(cid)
            if c is None:  # beyond the gc horizon: no ancestry there
                continue
            if c.parent_id:
                stack.append(c.parent_id)
            if c.extra_parent_id:
                stack.append(c.extra_parent_id)
        return None

    # --------------------------------------------------------- reachability
    def reachable_commits(
        self,
        *,
        extra_roots: Sequence[str] = (),
        history: Optional[int] = None,
    ) -> Dict[str, Commit]:
        """Enumerate commits reachable from every branch head, every tag
        and ``extra_roots`` — the mark phase's catalog walk.

        ``history`` bounds the walk depth from each *branch head* (None =
        unlimited): ``history=1`` keeps only the heads themselves,
        Iceberg-style snapshot expiry.  Tag and extra roots are always
        kept but their ancestry honours the same bound, counted from the
        root.  Merge parents (``extra_parent_id``) count as one step like
        first parents.
        """
        if history is not None and history < 1:
            # history=0 would mark NOTHING live — a sweep against that
            # live set destroys every branch head's data
            raise ValueError(f"history must be >= 1, got {history}")
        roots: List[str] = []
        for branch in self.branches():
            ref = self.store.get_ref(_BRANCH_NS, branch)
            if ref is not None:
                roots.append(ref["commit"])
        roots.extend(self.tags().values())
        roots.extend(extra_roots)

        out: Dict[str, Commit] = {}
        if history is None:
            # unbounded: a plain visited-set walk — shared ancestry is
            # traversed once regardless of how many roots reach it
            stack = list(roots)
            while stack:
                cid = stack.pop()
                if cid in out:
                    continue
                c = self.get_commit_opt(cid)
                if c is None:
                    continue  # dangling root or expired parent
                out[cid] = c
                if c.parent_id:
                    stack.append(c.parent_id)
                if c.extra_parent_id:
                    stack.append(c.extra_parent_id)
            return out

        # depth-bounded: a commit must be re-expanded when another root
        # reaches it shallower (its ancestry extends further down)
        best_depth: Dict[str, int] = {}
        dstack: List[tuple] = [(cid, 1) for cid in roots]
        while dstack:
            cid, depth = dstack.pop()
            if depth > history:
                continue
            if best_depth.get(cid, 1 << 60) <= depth:
                continue  # already visited at least this shallowly
            c = self.get_commit_opt(cid)
            if c is None:
                continue  # dangling root or expired parent
            best_depth[cid] = depth
            out[cid] = c
            if c.parent_id:
                dstack.append((c.parent_id, depth + 1))
            if c.extra_parent_id:
                dstack.append((c.extra_parent_id, depth + 1))
        return out

    def merge(
        self,
        source: str,
        target: str,
        *,
        message: str = "",
        author: str = "user",
        delete_source: bool = False,
    ) -> Commit:
        """Three-way merge of branch ``source`` into branch ``target``.

        Table-level granularity (a table is the merge unit, like Nessie's
        content keys): if both sides changed the same table since the merge
        base, raise ``MergeConflict`` — the paper's runner avoids this by
        construction because ephemeral branches merge back immediately.
        """
        for _ in range(64):
            src_head = self.head(source)
            tgt_ref = self.store.get_ref(_BRANCH_NS, target)
            if tgt_ref is None:
                raise CatalogError(f"no such branch {target!r}")
            tgt_head = self.get_commit(tgt_ref["commit"])
            base_id = self.merge_base(src_head.commit_id, tgt_head.commit_id)
            base_tables = self.get_commit(base_id).tables if base_id else {}
            merged = dict(tgt_head.tables)
            for name in set(src_head.tables) | set(base_tables):
                src_val = src_head.tables.get(name)
                tgt_val = tgt_head.tables.get(name)
                base_val = base_tables.get(name)
                if src_val == base_val:
                    continue  # source didn't touch it
                if tgt_val != base_val and tgt_val != src_val:
                    raise MergeConflict(
                        f"table {name!r} changed on both {source!r} and {target!r}"
                    )
                if src_val is None:
                    merged.pop(name, None)
                else:
                    merged[name] = src_val
            commit = self._write_commit(
                parent_id=tgt_head.commit_id,
                tables=merged,
                message=message or f"merge {source} into {target}",
                author=author,
                extra_parent_id=src_head.commit_id,
            )
            if self.store.compare_and_set_ref(
                _BRANCH_NS, target, tgt_ref, {"commit": commit.commit_id}
            ):
                if delete_source:
                    self.delete_branch(source)
                return commit
        raise CatalogError(f"merge contention on branch {target!r}")

    # ----------------------------------------------------------------- tags
    def tag(self, name: str, commit_id: str) -> None:
        self.store.set_ref(_TAG_NS, name, {"commit": commit_id})

    def tags(self) -> Dict[str, str]:
        """All tags: name -> commit id."""
        return {
            name: ref["commit"]
            for name, ref in self.store.list_refs(_TAG_NS).items()
        }

    def resolve_tag(self, name: str) -> str:
        ref = self.store.get_ref(_TAG_NS, name)
        if ref is None:
            raise CatalogError(f"no such tag {name!r}")
        return ref["commit"]
