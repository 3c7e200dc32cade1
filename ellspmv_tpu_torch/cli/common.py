"""The `ellspmv` and `csrspmv` programs on PyTorch: the counterpart of
``ellspmv_tpu.cli.common`` for the ELLPACK, DIA, SELL, hybrid, stream and
CSR formats, the auto chooser (DIA, ELL, SELL or stream), both timing
protocols, ``--reorder=rcm``, ``--backend=xla``, the ``--papi-event-*``
reports and ``--trace=DIR``, on one device.

Flag-compatible with the JAX package's parser, which follows the
reference's (parse_program_options, ellspmv.c:465-611): ``--opt=v`` and
``--opt v`` forms, the ``--`` terminator, up to three positional Matrix
Market paths ``A [x] [y]``, and the same error texts. `csrspmv` takes the
reference's CSR options (csrspmv.c:667-899): the partition flags are
accepted and name the kernel in the report, as the JAX program does on one
device, and the A64FX placement flags are accepted and ignored. One flag is
new:
``--device=cuda|cpu`` (default cuda), because PyTorch does not pick a
platform by itself. With the default and no card the program exits 1; it
never moves to the CPU by itself.

``--devices=N`` with N > 1, the one option of the JAX package this port
does not yet have, is parsed and then refused with exit code 1 and
``<program>: --devices=N is not yet ported (see ROADMAP.md)``.

Output protocol as in the reference: stderr is the log channel, stdout the
data channel (y as a Matrix Market vector, suppressed by ``-q``,
ellspmv.c:1899-1912).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

PROGRAM_VERSION = "0.1.0"


class CliError(Exception):
    pass


def _split_eq(arg: str, name: str):
    if arg == name:
        return None
    if arg.startswith(name + "="):
        return arg[len(name) + 1:]
    return False


class Options:
    def __init__(self, program: str):
        self.program = program
        self.A_path = None
        self.x_path = None
        self.y_path = None
        self.gzip = False
        self.separate_diagonal = False
        self.sort_rows = False
        self.repeat = 1
        self.warmup = 0
        self.quiet = False
        self.verbose = 0
        # --papi-*: the derived-metric and roofline reports
        self.papi_event_file = None
        self.papi_event_format = "plain"
        self.papi_event_per_thread = False
        self.papi_event_summary = False
        self.precision = "float64"
        self.index_width = None          # None=auto, 32, 64
        self.backend = "auto"
        self.protocol = "per_iter"
        self.devices = 1
        self.trace_dir = None
        self.reorder = "none"
        self.format = None
        self.device = "cuda"
        # csrspmv: the partition flags (one device: they name the kernel)
        # and the A64FX placement flags (accepted, ignored)
        self.partition = "rows"
        self.precompute_partition = False
        self.rows_per_thread = None
        self.columns_per_thread = None
        self.l1_prefetch_distance = None
        self.l2_prefetch_distance = None


def print_help(program: str, csr: bool = False, f=None):
    f = f or sys.stdout
    f.write(f"Usage: {program} [OPTION..] A [x] [y]\n\n")
    f.write(" Multiply a matrix by a vector: y := A*x + y.\n\n")
    f.write(" Positional arguments are:\n")
    f.write("  A    path to Matrix Market file for the matrix A\n")
    f.write("  x    optional path to Matrix Market file for the vector x\n")
    f.write("  y    optional path to Matrix Market file for the vector y\n\n")
    f.write(" Other options are:\n")
    f.write("  -z, --gzip, --gunzip, --ungzip    filter files through gzip\n")
    f.write("  --separate-diagonal       store diagonal nonzeros separately\n")
    f.write("  --sort-rows               sort nonzeros by column within each row\n")
    if csr:
        f.write("  --partition-rows          partition rows evenly among devices (default)\n")
        f.write("  --partition-nonzeros      partition nonzeros evenly among devices\n")
        f.write("  --precompute-partition    perform per-device partitioning once as a precomputation\n")
        f.write("  --rows-per-thread=N..     comma-separated list of rows assigned to devices\n")
        f.write("  --columns-per-thread=N..  accepted for compatibility (ignored)\n")
        f.write("  --l1-prefetch-distance=N  accepted for compatibility (A64FX only; ignored)\n")
        f.write("  --l2-prefetch-distance=N  accepted for compatibility (A64FX only; ignored)\n")
    f.write("  --repeat=N                repeat matrix-vector multiplication N times\n")
    f.write("  --warmup=N                perform N additional warmup iterations\n")
    f.write("  -q, --quiet               do not print Matrix Market output\n")
    f.write("  -v, --verbose             be more verbose\n\n")
    f.write(" Options for performance monitoring are:\n")
    f.write("  --papi-event-file=FILE    derived-metric definition file (formulas over\n")
    f.write("                            time/flops/bytes; see examples/tpu_membw.metrics)\n")
    f.write("  --papi-event-format=FMT   output format for metrics: plain or csv. [plain]\n")
    f.write("  --papi-event-per-thread   display metrics per device\n")
    f.write("  --papi-event-summary      display summary of performance monitoring\n\n")
    f.write(" Device options are:\n")
    f.write("  --device=D                cuda (default) or cpu; cuda fails when no\n")
    f.write("                            card is present\n")
    f.write("  --precision=DTYPE         float64 (default), float32 or bfloat16\n")
    f.write("  --index-width=N           32 or 64 (default: auto; IDXTYPEWIDTH analogue)\n")
    f.write("  --backend=B               auto (default) or pallas: the hand-written\n")
    f.write("                            kernels; xla: their plain PyTorch versions\n")
    f.write("                            for ELL, CSR, SELL and hybrid\n")
    f.write("  --protocol=P              per_iter (default) or chained timing\n")
    f.write("  --trace=DIR               write a torch.profiler trace of the benchmark\n")
    f.write("                            loop to DIR (PAPI-region analogue)\n")
    if not csr:
        f.write("  --format=F                ell (default), auto (DIA, ELL, SELL or stream,\n")
        f.write("                            whichever the card runs fastest by its\n")
        f.write("                            price), dia (stencil diagonals), sell (sliced\n")
        f.write("                            ELL, for a few long rows), hybrid (hub columns\n")
        f.write("                            + sliced ELL) or stream (for power-law matrices)\n")
    f.write("  --reorder=R               none (default) or rcm: reverse Cuthill-McKee\n")
    f.write("                            inside; x, y and the output keep their order\n\n")
    f.write(" Not yet ported (accepted, then refused with exit code 1):\n")
    f.write("  --devices=N>1\n\n")
    f.write("  -h, --help                display this help and exit\n")
    f.write("  --version                 display version information and exit\n")


def print_version(program: str, f=None):
    import torch
    f = f or sys.stdout
    f.write(f"{program} {PROGRAM_VERSION} (ellspmv-tpu, PyTorch port)\n")
    f.write("row/column offsets: 32-bit or 64-bit (auto-selected)\n")
    f.write(f"torch: {torch.__version__} (CUDA {torch.version.cuda})\n")
    if torch.cuda.is_available():
        f.write(f"devices: {torch.cuda.device_count()} x "
                f"{torch.cuda.get_device_name(0)}\n")
    else:
        f.write("devices: no CUDA device\n")


def parse_args(argv: list[str], program: str, csr: bool = False) -> Options:
    opts = Options(program)
    positional = []
    i = 0
    only_positional = False

    def need_value(val, name):
        nonlocal i
        if val is None:
            i += 1
            if i >= len(argv):
                raise CliError(f"option '{name}' requires an argument")
            return argv[i]
        return val

    while i < len(argv):
        arg = argv[i]
        if only_positional or not arg.startswith("-") or arg == "-":
            positional.append(arg)
            i += 1
            continue
        if arg == "--":
            only_positional = True
            i += 1
            continue
        if arg in ("-h", "--help"):
            print_help(program, csr)
            raise SystemExit(0)
        if arg == "--version":
            print_version(program)
            raise SystemExit(0)
        if arg in ("-z", "--gzip", "--gunzip", "--ungzip"):
            opts.gzip = True
        elif arg == "--separate-diagonal":
            opts.separate_diagonal = True
        elif arg == "--sort-rows":
            opts.sort_rows = True
        elif arg in ("-q", "--quiet"):
            opts.quiet = True
        elif arg in ("-v", "--verbose"):
            opts.verbose += 1
        elif arg == "-vv":
            opts.verbose += 2
        elif (v := _split_eq(arg, "--repeat")) is not False:
            opts.repeat = int(need_value(v, "--repeat"))
        elif (v := _split_eq(arg, "--warmup")) is not False:
            opts.warmup = int(need_value(v, "--warmup"))
        elif csr and arg == "--partition-rows":
            opts.partition = "rows"
        elif csr and arg == "--partition-nonzeros":
            opts.partition = "nonzeros"
        elif csr and arg == "--precompute-partition":
            opts.precompute_partition = True
        elif csr and (v := _split_eq(arg, "--rows-per-thread")) is not False:
            v = need_value(v, "--rows-per-thread")
            opts.rows_per_thread = [int(s) for s in v.split(",") if s]
        elif csr and (v := _split_eq(arg, "--columns-per-thread")) is not False:
            v = need_value(v, "--columns-per-thread")
            opts.columns_per_thread = [int(s) for s in v.split(",") if s]
        elif csr and (v := _split_eq(arg, "--l1-prefetch-distance")) is not False:
            opts.l1_prefetch_distance = int(need_value(v, "--l1-prefetch-distance"))
        elif csr and (v := _split_eq(arg, "--l2-prefetch-distance")) is not False:
            opts.l2_prefetch_distance = int(need_value(v, "--l2-prefetch-distance"))
        elif (v := _split_eq(arg, "--papi-event-file")) is not False:
            opts.papi_event_file = need_value(v, "--papi-event-file")
        elif (v := _split_eq(arg, "--papi-event-format")) is not False:
            opts.papi_event_format = need_value(v, "--papi-event-format")
            if opts.papi_event_format not in ("plain", "csv"):
                raise CliError("--papi-event-format must be plain or csv")
        elif arg == "--papi-event-per-thread":
            opts.papi_event_per_thread = True
        elif arg == "--papi-event-summary":
            opts.papi_event_summary = True
        elif (v := _split_eq(arg, "--precision")) is not False:
            opts.precision = need_value(v, "--precision")
            if opts.precision not in ("float64", "float32", "bfloat16"):
                raise CliError("--precision must be float64, float32 or bfloat16")
        elif (v := _split_eq(arg, "--index-width")) is not False:
            opts.index_width = int(need_value(v, "--index-width"))
            if opts.index_width not in (32, 64):
                raise CliError("--index-width must be 32 or 64")
        elif (v := _split_eq(arg, "--backend")) is not False:
            opts.backend = need_value(v, "--backend")
            if opts.backend not in ("auto", "pallas", "xla"):
                raise CliError("--backend must be auto, pallas or xla")
        elif (v := _split_eq(arg, "--protocol")) is not False:
            opts.protocol = need_value(v, "--protocol")
            if opts.protocol not in ("per_iter", "chained"):
                raise CliError("--protocol must be per_iter or chained")
        elif (v := _split_eq(arg, "--devices")) is not False:
            opts.devices = int(need_value(v, "--devices"))
        elif (v := _split_eq(arg, "--trace")) is not False:
            opts.trace_dir = need_value(v, "--trace")
        elif not csr and (v := _split_eq(arg, "--format")) is not False:
            opts.format = need_value(v, "--format")
            if opts.format not in ("auto", "ell", "dia", "sell", "hybrid",
                                   "stream"):
                raise CliError("--format must be auto, ell, dia, sell, "
                               "hybrid or stream")
        elif (v := _split_eq(arg, "--reorder")) is not False:
            opts.reorder = need_value(v, "--reorder")
            if opts.reorder not in ("none", "rcm"):
                raise CliError("--reorder must be none or rcm")
        elif (v := _split_eq(arg, "--device")) is not False:
            opts.device = need_value(v, "--device")
            if opts.device not in ("cuda", "cpu"):
                raise CliError("--device must be cuda or cpu")
        else:
            raise CliError(f"unrecognized option '{arg}'")
        i += 1

    if len(positional) > 3:
        raise CliError("too many positional arguments")
    if not positional:
        # mirror the reference: print usage and fail (ellspmv.c:607-610)
        sys.stderr.write(f"Usage: {program} [OPTION..] A [x] [y]\n")
        raise SystemExit(1)
    opts.A_path = positional[0]
    if len(positional) > 1:
        opts.x_path = positional[1]
    if len(positional) > 2:
        opts.y_path = positional[2]
    return opts


def card_missing(program: str, device: str) -> bool:
    """Whether `device` is cuda and no card is present; if so, say so on
    stderr. The programs then exit 1: none moves to the CPU by itself."""
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        sys.stderr.write(f"{program}: --device=cuda: no CUDA device is "
                         "available (use --device=cpu to run on the CPU)\n")
        return True
    return False


def unported_option(opts: Options) -> str | None:
    """The given option that this port does not have yet (more than one
    device), or None."""
    if opts.devices > 1:
        return f"--devices={opts.devices}"
    return None


def kernel_name(opts: Options, mat, csr: bool = False) -> str:
    """Kernel label in the reference's naming (gemv/gemvsd/gemv16,
    README:133; csrgemv/csrgemvsd/csrgemvnz/csrgemvrp, csrspmv.c:2851-2868),
    and gemv_dia, gemv_sell, gemv_hybrid or gemv_stream for DIA, SELL, the
    hybrid or the stream format, as in the JAX program."""
    from ellspmv_tpu_torch.formats.dia import DiaMatrix
    from ellspmv_tpu_torch.formats.hybrid import HybridMatrix
    from ellspmv_tpu_torch.formats.sell import SellMatrix
    from ellspmv_tpu_torch.formats.stream import StreamMatrix
    if csr:
        if opts.partition == "nonzeros":
            return "csrgemvnz"
        if opts.rows_per_thread:
            return "csrgemvrp"
        return "csrgemvsd" if opts.separate_diagonal else "csrgemv"
    if isinstance(mat, DiaMatrix):
        return "gemv_dia"
    if isinstance(mat, SellMatrix):
        return "gemv_sell"
    if isinstance(mat, HybridMatrix):
        return "gemv_hybrid"
    if isinstance(mat, StreamMatrix):
        return "gemv_stream"
    if opts.separate_diagonal and mat.rowsize == 16:
        return "gemv16"
    return "gemvsd" if opts.separate_diagonal else "gemv"


def metrics_report(res, opts: Options, log):
    """The roofline summary that stands in for the PAPI region report
    (papi_util.c:424-494), plain or CSV
    (``ellspmv_tpu.cli.common._metrics_report``, its lines). On the CPU,
    which has no device memory, the roofline fields read "not measured"
    (CSV: empty)."""
    m = res.metrics
    t = res.best
    act = res.actual_gb_per_s()
    peak = res.hbm_peak
    if opts.papi_event_format == "csv":
        log.write("region,repeat,time,nonzeros,flops,min_bytes,max_bytes,"
                  "gnz_per_s,gflop_per_s,min_gb_per_s,max_gb_per_s,"
                  "hbm_peak_gb_per_s,roofline_fraction,"
                  "actual_bytes,actual_gb_per_s,physical_roofline\n")
        roof = ("," if peak is None else
                f"{peak / 1e9:.1f},{res.roofline_fraction():.4f}")
        phys = ("" if peak is None else f"{res.physical_roofline():.4f}")
        log.write(f"gemv,{len(res.times)},{t:.9f},{m.num_nonzeros},"
                  f"{m.num_flops},{m.min_bytes},{m.max_bytes},"
                  f"{res.gnz_per_s():.3f},{res.gflop_per_s():.3f},"
                  f"{res.min_gb_per_s():.3f},{res.max_gb_per_s():.3f},"
                  f"{roof},"
                  + ("," if act is None else
                     f"{res.actual_bytes},{act:.3f},{phys}") + "\n")
        return
    log.write("Region: gemv\n")
    log.write(f"  iterations: {len(res.times)}\n")
    log.write(f"  best time: {t:.6f} s\n")
    log.write(f"  nonzeros: {m.num_nonzeros:,}  flops/iter: {m.num_flops:,}\n")
    log.write(f"  bytes/iter: {m.min_bytes:,} (x once) to {m.max_bytes:,} "
              "(x per nonzero)\n")
    log.write(f"  throughput: {res.gnz_per_s():.3f} Gnz/s, "
              f"{res.gflop_per_s():.3f} Gflop/s\n")
    log.write(f"  effective bandwidth: {res.min_gb_per_s():.1f} to "
              f"{res.max_gb_per_s():.1f} GB/s\n")
    if peak is None:
        log.write("  HBM roofline: not measured (no device memory on the "
                  "CPU)\n")
    else:
        log.write(f"  HBM roofline: {peak / 1e9:.1f} GB/s peak -> "
                  f"{100 * res.roofline_fraction():.1f}% of peak "
                  "(min-bytes model; formats that store less than ELLPACK "
                  "can exceed 100%)\n")
    if act is not None:
        share = ("not measured" if peak is None else
                 f"{100 * res.physical_roofline():.1f}% of raw HBM")
        log.write(f"  physical traffic: {res.actual_bytes:,} bytes/iter "
                  f"(device plan) -> {act:.1f} GB/s = {share}\n")


def _convert(coo, opts: Options, index_dtype, device, csr: bool = False):
    """The matrix in the format `opts` asks for (CSR for `csrspmv`), on
    `device`, with the name and the tail of the verbose conversion line
    (ellspmv_tpu.cli.common._convert)."""
    if csr:
        from ellspmv_tpu_torch.formats.csr import csr_from_coo
        mat = csr_from_coo(coo, separate_diagonal=opts.separate_diagonal,
                           sort_rows=opts.sort_rows,
                           value_dtype=opts.precision,
                           index_dtype=index_dtype, device=device)
        return (mat, "csr_from_coo", f", {mat.rowsize_min} to "
                f"{mat.rowsize_max} nonzeros per row")
    if opts.format == "auto":
        from ellspmv_tpu_torch.formats.auto import auto_from_coo
        mat = auto_from_coo(coo, separate_diagonal=opts.separate_diagonal,
                            sort_rows=opts.sort_rows,
                            value_dtype=opts.precision,
                            index_dtype=index_dtype, device=device)
        return (mat, f"auto_from_coo [{mat._auto_choice}]",
                f", {mat._auto_reason}")
    if opts.format == "dia":
        from ellspmv_tpu_torch.formats.dia import dia_from_coo
        mat = dia_from_coo(coo, value_dtype=opts.precision, device=device)
        if mat is None:
            raise CliError("--format=dia: matrix has too many distinct "
                           "diagonals for DIA")
        return mat, "dia_from_coo", f", {mat.num_diags} diagonals"
    if opts.format == "sell":
        from ellspmv_tpu_torch.formats.sell import sell_from_coo
        mat = sell_from_coo(coo, sort_rows=True, length_sort=True,
                            value_dtype=opts.precision,
                            index_dtype=index_dtype, device=device)
        return mat, "sell_from_coo", f", {len(mat.buckets)} slice buckets"
    if opts.format == "hybrid":
        from ellspmv_tpu_torch.formats.hybrid import hybrid_from_coo
        mat = hybrid_from_coo(coo, value_dtype=opts.precision,
                              index_dtype=index_dtype, device=device)
        return (mat, "hybrid_from_coo",
                f", hub fraction {mat.hub_nnz_fraction:.2f}")
    if opts.format == "stream":
        from ellspmv_tpu_torch.formats.stream import stream_from_coo
        mat = stream_from_coo(coo, separate_diagonal=opts.separate_diagonal,
                              value_dtype=opts.precision, device=device)
        return (mat, "stream_from_coo",
                f", {len(mat.ddsum.levels)} sum levels")
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    mat = ell_from_coo(coo, separate_diagonal=opts.separate_diagonal,
                       sort_rows=opts.sort_rows, value_dtype=opts.precision,
                       index_dtype=index_dtype, device=device)
    return mat, "ell_from_coo", f", {mat.rowsize} nonzeros per row"


def run(argv: list[str], program: str, csr: bool = False) -> int:
    """The program's main body; `csr` makes it `csrspmv`."""
    try:
        opts = parse_args(argv, program, csr)
    except (CliError, ValueError) as e:
        sys.stderr.write(f"{program}: {e}\n")
        return 1
    unported = unported_option(opts)
    if unported is not None:
        sys.stderr.write(f"{program}: {unported} is not yet ported "
                         "(see ROADMAP.md)\n")
        return 1

    import torch

    from ellspmv_tpu_torch.bench.harness import benchmark_spmv
    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.io.mtx import read_matrix, read_vector, write_vector

    if card_missing(program, opts.device):
        return 1
    device = torch.device(opts.device)
    log = sys.stderr
    index_dtype = f"int{opts.index_width}" if opts.index_width else None
    if (opts.columns_per_thread or opts.l1_prefetch_distance
            or opts.l2_prefetch_distance) and opts.verbose:
        log.write(f"{program}: note: NUMA/A64FX placement options have no "
                  "analogue on a CUDA card; ignored\n")
    if (opts.separate_diagonal and opts.format in ("dia", "sell", "hybrid")
            and opts.verbose):
        log.write(f"{program}: note: --format={opts.format} stores the "
                  "diagonal inline; --separate-diagonal ignored\n")
    if opts.format == "auto" and opts.verbose:
        if not opts.sort_rows:
            log.write(f"{program}: note: --format=auto implies sorted rows "
                      "(column locality drives the format choice)\n")
        if opts.index_width:
            log.write(f"{program}: note: --format=auto may choose the "
                      "stream format, which stores int32 positions "
                      "regardless of --index-width\n")

    # Phase 2: read the matrix (timed, like ellspmv.c:1264-1377)
    t0 = time.perf_counter()
    try:
        coo = read_matrix(opts.A_path, gzipped=opts.gzip or None,
                          index_dtype=index_dtype, value_dtype=np.float64)
    except Exception as e:
        sys.stderr.write(f"{program}: {opts.A_path}: {e}\n")
        return 1
    t_read = time.perf_counter() - t0
    if opts.verbose:
        try:
            mb = os.path.getsize(opts.A_path) / 1e6
        except OSError:
            mb = 0.0
        log.write(f"mtxfile_read: {t_read:.6f} seconds ({mb / t_read:.1f} "
                  f"MB/s)\n")

    # Optional internal reordering (output-equivalent: x and y are permuted
    # at the edges). Square matrices only.
    reorder_map = None
    if opts.reorder == "rcm":
        if coo.num_rows != coo.num_columns:
            sys.stderr.write(f"{program}: --reorder=rcm needs a square "
                             "matrix\n")
            return 1
        from ellspmv_tpu_torch.models.reorder import reorder_rcm
        t0 = time.perf_counter()
        reorder_map = reorder_rcm(coo)
        coo = reorder_map.coo
        if opts.verbose:
            log.write(f"reorder_rcm: {time.perf_counter() - t0:.6f} "
                      "seconds\n")

    # Phase 3: convert (timed, like ellspmv.c:1379-1486). The time includes
    # the copy to the device (and, for ELL, the slot-major transpose there).
    t0 = time.perf_counter()
    try:
        mat, convert_name, per_row = _convert(coo, opts, index_dtype, device,
                                              csr)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    except (MemoryError, torch.cuda.OutOfMemoryError) as e:
        sys.stderr.write(f"{program}: conversion failed: {e}\n")
        return 1
    except (CliError, NotImplementedError, ValueError) as e:
        sys.stderr.write(f"{program}: {e}\n")
        return 1
    t_conv = time.perf_counter() - t0
    if opts.verbose:
        log.write(f"{convert_name}: {t_conv:.6f} seconds, "
                  f"{mat.num_rows:,} rows, {mat.num_nonzeros:,} nonzeros"
                  f"{per_row}\n")
        name = (torch.cuda.get_device_name(device)
                if device.type == "cuda" else "host CPU")
        log.write(f"device: {device} ({name})\n")
        if opts.backend == "xla":
            log.write("backend: xla (the plain PyTorch versions of the ELL, "
                      "CSR, SELL and hybrid kernels, on the device)\n")

    # Phase 4: vectors
    try:
        if opts.x_path:
            x = read_vector(opts.x_path, gzipped=opts.gzip or None)
            if len(x) != mat.num_columns:
                sys.stderr.write(
                    f"{program}: {opts.x_path}: expected vector of length "
                    f"{mat.num_columns}, got {len(x)}\n")
                return 1
        else:
            x = np.ones(mat.num_columns)   # ellspmv.c:1502-1505
        if opts.y_path:
            y = read_vector(opts.y_path, gzipped=opts.gzip or None)
            if len(y) != mat.num_rows:
                sys.stderr.write(
                    f"{program}: {opts.y_path}: expected vector of length "
                    f"{mat.num_rows}, got {len(y)}\n")
                return 1
        else:
            y = None                        # zeros (ellspmv.c:1610-1613)
    except Exception as e:
        sys.stderr.write(f"{program}: {e}\n")
        return 1
    if reorder_map is not None:
        x = reorder_map.permute_x(x)
        if y is not None:
            y = reorder_map.permute_x(y)   # same row permutation
    dtype = value_dtype(opts.precision)
    x = torch.from_numpy(x).to(device).to(dtype)
    if y is not None:
        y = torch.from_numpy(y).to(device).to(dtype)

    # Phase 5: benchmark (warmup + timed loop, ellspmv.c:1745-1876, or the
    # chained slope), traced with --trace. --backend=auto and
    # --backend=pallas both run the hand-written kernels.
    from ellspmv_tpu_torch.ops.dispatch import spmv
    from ellspmv_tpu_torch.utils.trace import device_trace

    def spmv_fn(m, xv, yv):
        return spmv(m, xv, yv, backend=opts.backend)
    name = kernel_name(opts, mat, csr)
    try:
        with device_trace(opts.trace_dir):
            res = benchmark_spmv(spmv_fn, mat, x, y, repeat=opts.repeat,
                                 warmup=opts.warmup, protocol=opts.protocol)
    except Exception as e:
        sys.stderr.write(f"{program}: benchmark failed: {e}\n")
        return 1
    if opts.verbose:
        for line in res.iteration_lines():
            log.write(f"{name}: {line}\n")
        if res.warning:
            log.write(f"{program}: warning: {res.warning}\n")
    if opts.papi_event_file:
        from ellspmv_tpu_torch.bench import metrics as metrics_mod
        try:
            mfile = metrics_mod.read_metrics_file(opts.papi_event_file)
            metrics_mod.report(mfile, metrics_mod.base_events(res), log,
                               fmt=opts.papi_event_format, region=name)
        except (OSError, metrics_mod.MetricsError) as e:
            sys.stderr.write(f"{program}: {opts.papi_event_file}: {e}\n")
            return 1
    if opts.papi_event_summary:
        metrics_report(res, opts, log)
    if opts.papi_event_per_thread:
        log.write(f"{program}: note: --papi-event-per-thread with one "
                  "device: the whole-matrix region IS the per-device row "
                  "(use --devices=N for a breakdown)\n")

    # Phase 6: write y to stdout (ellspmv.c:1898-1912)
    if not opts.quiet:
        t0 = time.perf_counter()
        y_out = res.y.double().cpu().numpy()
        if reorder_map is not None:
            y_out = reorder_map.unpermute_y(y_out)
        write_vector(sys.stdout, y_out)
        if opts.verbose:
            log.write(f"mtxfile_write: {time.perf_counter() - t0:.6f} "
                      "seconds\n")
    return 0
