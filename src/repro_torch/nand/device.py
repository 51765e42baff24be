"""3D NAND device model (paper §IV-C, Fig. 9, Table II) — copy of
``src/repro/nand/device.py`` (pure Python).

Analytical read-latency/energy/area model for a 96-layer 3D NAND core,
calibrated to the paper's reported design points:

  * commercial SSD-class chips (8-16 KB pages, hundreds of blocks):
    15-90 us page reads — precharge/discharge of the huge BL capacitance is
    ~90% of the latency [55]
  * the customized Proxima core (N_BL=36864, N_SSL=4, N_block=64, 32:1 BL
    MUX -> 128 B granularity): < 300 ns reads

Latency model: t_read = t_pre + t_wl + t_sense + t_xfer, with
t_pre ∝ C_BL ∝ (N_block stacked on the bitline) x (precharged BL count).
The 32:1 MUX divides the precharged BL count (partial precharging), which
both cuts t_pre and shrinks the page buffer 32x (§IV-C).

Energy/area constants come straight from Table II.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NandConfig:
    # -- geometry (Proxima defaults, §IV-C / Table II)
    n_bl: int = 36864                 # bitlines per core
    n_ssl: int = 4
    n_block: int = 64                 # blocks per core (BL capacitive load)
    bl_mux: int = 32                  # 32:1 BL MUX -> partial precharge
    n_layers: int = 96
    cores_per_tile: int = 32
    n_tiles: int = 16
    n_planes: int = 4                 # independent planes per core: the cap
                                      # on same-round parallel page reads
                                      # (beam-parallel traversal issues up to
                                      # min(E, n_planes) reads concurrently)
    # -- timing calibration
    t_wl_setup_ns: float = 20.0       # word-line setup
    t_sense_ns: float = 25.0          # sense amp
    # precharge: t_pre = k_pre * (n_block/64) * (bl_precharged/1152)
    k_pre_ns: float = 230.0           # calibrated -> ~300 ns Proxima core
    bus_bytes_per_ns: float = 32.0    # Cu-Cu bonded H-tree bandwidth/core
    # -- energy (Table II)
    e_core_read_pj: float = 4442.0    # 3D NAND block read, dynamic
    e_core_htree_pj: float = 21.4
    e_tile_htree_pj: float = 198.6
    # -- program/erase (SLC update path; reads stay the paper's fast path)
    t_program_base_ns: float = 60_000.0   # ISPP pulse train, one WL (SLC)
    t_erase_ns: float = 2_000_000.0       # block erase (~2 ms SLC)
    e_program_pj: float = 45_000.0        # one page program (ISPP + verify)
    e_erase_pj: float = 1_500_000.0       # one block erase
    pe_cycle_limit: int = 100_000         # SLC endurance (P/E cycles)
    # -- capacity
    bits_per_cell: int = 1            # SLC (ECC-free, §V-E)
    # -- channel pipelining (NDSEARCH-style round overlap)
    double_buffer: bool = False       # page buffer is double-buffered: page
                                      # reads for round t+1 overlap the PQ
                                      # scoring of round t, so a round's
                                      # critical path is max(read, score)
                                      # instead of read + score

    @property
    def n_cores(self) -> int:
        return self.cores_per_tile * self.n_tiles

    @property
    def page_bytes(self) -> int:
        """Effective data granularity after the BL MUX (128 B for defaults)."""
        return self.n_bl // self.bl_mux // 8

    @property
    def capacity_bits(self) -> int:
        # per core: n_bl x n_ssl x n_block x n_layers SLC cells
        per_core = self.n_bl * self.n_ssl * self.n_block * self.n_layers
        return per_core * self.n_cores * self.bits_per_cell

    # ------------------------------------------------------------- latency
    def read_latency_ns(self, page_bytes: int | None = None,
                        n_block: int | None = None) -> float:
        """Page read latency for a given effective page size / block load."""
        pb = page_bytes if page_bytes is not None else self.page_bytes
        nb = n_block if n_block is not None else self.n_block
        precharged_bl = pb * 8
        t_pre = self.k_pre_ns * (nb / 64.0) * (precharged_bl / 1152.0)
        t_xfer = pb / self.bus_bytes_per_ns
        return t_pre + self.t_wl_setup_ns + self.t_sense_ns + t_xfer

    def access_latency_ns(self, bytes_read: int) -> float:
        """One WL activation + streaming ``bytes_read`` through the BL MUX.
        A word line holds n_bl bits (4.6 KB); reading more bytes than one
        MUX-window adds only transfer cycles, NOT another precharge — this
        is what makes hot-node repetition a single-shot access (§IV-E)."""
        base = self.read_latency_ns()
        extra = max(0, bytes_read - self.page_bytes)
        return base + extra / self.bus_bytes_per_ns

    def access_energy_pj(self, bytes_read: int) -> float:
        """One WL activation + H-tree transfer of ``bytes_read``."""
        windows = max(1, -(-bytes_read // self.page_bytes))
        return (
            self.e_core_read_pj
            + windows * (self.e_core_htree_pj + self.e_tile_htree_pj)
        )

    # ------------------------------------------------------- program / erase
    @property
    def block_bytes(self) -> int:
        """Erase granularity: one block's cells across all layers/SSLs."""
        return self.n_bl * self.n_ssl * self.n_layers * self.bits_per_cell // 8

    def program_latency_ns(self, bytes_written: int) -> float:
        """Sequential page programs: each MUX-window page pays the full ISPP
        pulse train (program latency is verify-dominated, not width-dominated)
        plus the H-tree data load."""
        pages = max(1, -(-bytes_written // self.page_bytes))
        return pages * (
            self.t_program_base_ns + self.page_bytes / self.bus_bytes_per_ns
        )

    def program_energy_pj(self, bytes_written: int) -> float:
        pages = max(1, -(-bytes_written // self.page_bytes))
        return pages * (
            self.e_program_pj + self.e_core_htree_pj + self.e_tile_htree_pj
        )

    def erase_latency_ns(self, bytes_invalidated: int) -> float:
        """Block erases needed to reclaim ``bytes_invalidated``."""
        blocks = max(1, -(-bytes_invalidated // self.block_bytes))
        return blocks * self.t_erase_ns

    def erase_energy_pj(self, bytes_invalidated: int) -> float:
        blocks = max(1, -(-bytes_invalidated // self.block_bytes))
        return blocks * self.e_erase_pj

    # ---------------------------------------------------------- Fig 9 sweep
    def latency_density_tradeoff(self, page_sizes=(128, 512, 2048, 8192, 16384)):
        """Reproduces the Fig. 9 trend: latency and area efficiency vs page
        size (SSD-class large pages -> 10^4 ns reads; Proxima point < 300ns).
        Area efficiency proxy: NAND array area / (array + page buffer),
        where the page buffer scales with the un-muxed page width."""
        rows = []
        for pb in page_sizes:
            nb = 64 if pb <= 512 else 1024  # SSD-class chips stack more blocks
            lat = self.read_latency_ns(page_bytes=pb, n_block=nb)
            buffer_cost = pb * 8 / self.n_bl      # page-buffer area share proxy
            area_eff = 1.0 / (1.0 + 0.35 * buffer_cost * 32)
            rows.append({
                "page_bytes": pb,
                "n_block": nb,
                "read_latency_ns": lat,
                "area_efficiency": area_eff,
            })
        return rows
