"""Benchmark workloads from the paper's evaluation (§4).

* :class:`BankWorkload` — the partitioned Bank benchmark: accounts split into
  per-replica partitions; a transaction touches a single partition — its own
  replica's with probability ``locality`` (the paper's P), a random remote one
  otherwise.  50 % read-write transfers, 50 % read-only balance reads of
  varying length.
* :class:`TpccWorkload` — the TPC-C port: Payment (95 %) and New-Order (5 %)
  profiles over warehouse-partitioned data, injected through a geographic
  load-balancer that misroutes requests with probability 0.2.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from .cluster import TxnSpec, Workload
from .stm import Transaction, VersionedStore


# --------------------------------------------------------------------------
# Bank
# --------------------------------------------------------------------------

def _make_transfer(a: int, b: int, amount: float):
    def execute(store: VersionedStore, txn: Transaction) -> float:
        va = store.read(txn, a)
        vb = store.read(txn, b)
        store.write(txn, a, va - amount)
        store.write(txn, b, vb + amount)
        return va - amount

    return execute


def _make_balance_read(items: Tuple[int, ...]):
    def execute(store: VersionedStore, txn: Transaction) -> float:
        return float(sum(store.read(txn, i) for i in items))

    return execute


@dataclass
class BankWorkload(Workload):
    n_nodes: int
    n_items: int
    locality: float = 0.9          # the paper's P
    write_fraction: float = 0.5    # 50% read-write / 50% read-only
    ro_len: Tuple[int, int] = (2, 8)
    # overload-experiment mode: with probability ``hot_fraction`` every node
    # accesses ``hot_partition``; the hot partition's home node accesses ONLY
    # its own partition (paper §4, Fig. 3c setup).
    hot_partition: int = -1
    hot_fraction: float = 0.2

    def partition_bounds(self, p: int) -> Tuple[int, int]:
        size = self.n_items // self.n_nodes
        return p * size, (p + 1) * size

    def _choose_partition(self, node: int, rng: np.random.Generator) -> int:
        if self.hot_partition >= 0:
            if node == self.hot_partition:
                return node
            if rng.random() < self.hot_fraction:
                return self.hot_partition
        if rng.random() < self.locality:
            return node
        others = [p for p in range(self.n_nodes) if p != node]
        return int(others[rng.integers(len(others))])

    def sample(self, node: int, rng: np.random.Generator) -> TxnSpec:
        p = self._choose_partition(node, rng)
        lo, hi = self.partition_bounds(p)
        if rng.random() < self.write_fraction:
            a, b = rng.choice(np.arange(lo, hi), size=2, replace=False)
            amount = float(rng.integers(1, 20))
            return TxnSpec(
                execute=_make_transfer(int(a), int(b), amount),
                items=(int(a), int(b)),
                read_only=False,
                opt_hint=p,
            )
        k = int(rng.integers(self.ro_len[0], self.ro_len[1] + 1))
        items = tuple(int(i) for i in rng.choice(np.arange(lo, hi), size=k, replace=False))
        return TxnSpec(
            execute=_make_balance_read(items),
            items=items,
            read_only=True,
            opt_hint=p,
        )


# --------------------------------------------------------------------------
# TPC-C (Payment + New-Order profiles)
# --------------------------------------------------------------------------

@dataclass
class TpccLayout:
    """Flattened item-space layout: one block per warehouse + a catalog."""

    n_nodes: int
    warehouses_per_node: int = 2
    n_districts: int = 10
    n_customers: int = 64
    n_stock: int = 128
    n_catalog: int = 256

    @property
    def n_warehouses(self) -> int:
        return self.n_nodes * self.warehouses_per_node

    @property
    def wh_block(self) -> int:
        return 1 + self.n_districts + self.n_customers + self.n_stock

    @property
    def n_items(self) -> int:
        return self.n_warehouses * self.wh_block + self.n_catalog

    def home_node(self, w: int) -> int:
        return w // self.warehouses_per_node

    def warehouse_row(self, w: int) -> int:
        return w * self.wh_block

    def district_row(self, w: int, d: int) -> int:
        return w * self.wh_block + 1 + d

    def customer_row(self, w: int, c: int) -> int:
        return w * self.wh_block + 1 + self.n_districts + c

    def stock_row(self, w: int, s: int) -> int:
        return w * self.wh_block + 1 + self.n_districts + self.n_customers + s

    def catalog_row(self, i: int) -> int:
        return self.n_warehouses * self.wh_block + i


def _make_payment(wrow: int, drow: int, crow: int, amount: float):
    def execute(store: VersionedStore, txn: Transaction) -> float:
        w = store.read(txn, wrow)
        d = store.read(txn, drow)
        c = store.read(txn, crow)
        store.write(txn, wrow, w + amount)
        store.write(txn, drow, d + amount)
        store.write(txn, crow, c - amount)
        return c - amount

    return execute


def _make_new_order(drow: int, stock_rows: Tuple[int, ...], catalog_rows: Tuple[int, ...], qty: float):
    def execute(store: VersionedStore, txn: Transaction) -> float:
        oid = store.read(txn, drow)
        store.write(txn, drow, oid + 1.0)
        total = 0.0
        for cat in catalog_rows:
            total += store.read(txn, cat)
        for s in stock_rows:
            v = store.read(txn, s)
            store.write(txn, s, v - qty if v >= qty else v - qty + 91.0)
        return total

    return execute


class TpccConflictMap:
    """Warehouse-aligned conflict classes: 4 classes per warehouse
    (warehouse+districts / customers / stock-low / stock-high) + 1 global
    class for the read-only catalog (excluded from lease footprints)."""

    CCS_PER_WH = 4

    def __init__(self, layout: TpccLayout) -> None:
        self.layout = layout
        self.n_classes = layout.n_warehouses * self.CCS_PER_WH + 1

    def of_item(self, item: int) -> int:
        lay = self.layout
        block = lay.wh_block
        if item >= lay.n_warehouses * block:
            return self.n_classes - 1  # catalog
        w, off = divmod(item, block)
        if off <= lay.n_districts:
            sub = 0  # warehouse row + districts
        elif off <= lay.n_districts + lay.n_customers:
            sub = 1  # customers
        else:
            s = off - 1 - lay.n_districts - lay.n_customers
            sub = 2 + (0 if s < lay.n_stock // 2 else 1)
        return w * self.CCS_PER_WH + sub

    def get_conflict_classes(self, items):
        return frozenset(self.of_item(i) for i in items)


@dataclass
class TpccWorkload(Workload):
    layout: TpccLayout
    payment_fraction: float = 0.95
    lb_mistake: float = 0.2            # geographic load-balancer error rate
    remote_customer: float = 0.15      # Payment: cross-warehouse customer
    remote_stock: float = 0.1          # New-Order: per-item cross-warehouse
    order_lines: Tuple[int, int] = (5, 10)
    exec_ms_payment: float = 0.12
    exec_ms_neworder: float = 0.35     # the long-running profile

    def _region_warehouse(self, node: int, rng: np.random.Generator) -> int:
        lay = self.layout
        if rng.random() < self.lb_mistake:
            w = int(rng.integers(lay.n_warehouses))
        else:
            w = int(node * lay.warehouses_per_node + rng.integers(lay.warehouses_per_node))
        return w

    def sample(self, node: int, rng: np.random.Generator) -> TxnSpec:
        lay = self.layout
        w = self._region_warehouse(node, rng)
        if rng.random() < self.payment_fraction:
            d = int(rng.integers(lay.n_districts))
            cw = w
            if rng.random() < self.remote_customer:
                cw = int(rng.integers(lay.n_warehouses))
            c = int(rng.integers(lay.n_customers))
            rows = (
                lay.warehouse_row(w),
                lay.district_row(w, d),
                lay.customer_row(cw, c),
            )
            return TxnSpec(
                execute=_make_payment(*rows, amount=float(rng.integers(1, 50))),
                items=rows,
                read_only=False,
                opt_hint=lay.home_node(w),
                exec_ms=self.exec_ms_payment,
            )
        # New-Order
        d = int(rng.integers(lay.n_districts))
        n_lines = int(rng.integers(self.order_lines[0], self.order_lines[1] + 1))
        stock_rows = []
        for _ in range(n_lines):
            sw = w
            if rng.random() < self.remote_stock:
                sw = int(rng.integers(lay.n_warehouses))
            stock_rows.append(lay.stock_row(sw, int(rng.integers(lay.n_stock))))
        catalog_rows = tuple(
            lay.catalog_row(int(i))
            for i in rng.integers(lay.n_catalog, size=n_lines)
        )
        drow = lay.district_row(w, d)
        items = tuple([drow] + stock_rows)  # catalog rows are read-only/global
        return TxnSpec(
            execute=_make_new_order(drow, tuple(stock_rows), catalog_rows, qty=5.0),
            items=items,
            read_only=False,
            opt_hint=lay.home_node(w),
            exec_ms=self.exec_ms_neworder,
        )
