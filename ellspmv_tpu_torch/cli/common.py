"""The `ellspmv` program on PyTorch: the counterpart of
``ellspmv_tpu.cli.common`` for the ELLPACK, DIA and stream formats, the auto
chooser (DIA, ELL or stream), both timing protocols and ``--reorder=rcm``.

Flag-compatible with the JAX package's parser, which follows the
reference's (parse_program_options, ellspmv.c:465-611): ``--opt=v`` and
``--opt v`` forms, the ``--`` terminator, up to three positional Matrix
Market paths ``A [x] [y]``, and the same error texts. One flag is new:
``--device=cuda|cpu`` (default cuda), because PyTorch does not pick a
platform by itself. With the default and no card the program exits 1; it
never moves to the CPU by itself.

Options the JAX package has and this port does not yet have are parsed and
then refused with exit code 1 and ``<program>: <option> is not yet ported
(see ROADMAP.md)``.

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
        self.papi_flags = []             # given --papi-* flags (not ported)
        self.precision = "float64"
        self.index_width = None          # None=auto, 32, 64
        self.backend = "auto"
        self.protocol = "per_iter"
        self.devices = 1
        self.trace_dir = None
        self.reorder = "none"
        self.format = None
        self.device = "cuda"


def print_help(program: str, f=None):
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
    f.write("  --repeat=N                repeat matrix-vector multiplication N times\n")
    f.write("  --warmup=N                perform N additional warmup iterations\n")
    f.write("  -q, --quiet               do not print Matrix Market output\n")
    f.write("  -v, --verbose             be more verbose\n\n")
    f.write(" Device options are:\n")
    f.write("  --device=D                cuda (default) or cpu; cuda fails when no\n")
    f.write("                            card is present\n")
    f.write("  --precision=DTYPE         float64 (default), float32 or bfloat16\n")
    f.write("  --index-width=N           32 or 64 (default: auto; IDXTYPEWIDTH analogue)\n")
    f.write("  --backend=B               auto (default) or pallas: the hand-written\n")
    f.write("                            kernel of the format\n")
    f.write("  --protocol=P              per_iter (default) or chained timing\n")
    f.write("  --format=F                ell (default), auto (DIA, ELL or stream,\n")
    f.write("                            whichever moves fewest bytes), dia (stencil\n")
    f.write("                            diagonals) or stream (for power-law matrices)\n")
    f.write("  --reorder=R               none (default) or rcm: reverse Cuthill-McKee\n")
    f.write("                            inside; x, y and the output keep their order\n\n")
    f.write(" Not yet ported (accepted, then refused with exit code 1):\n")
    f.write("  --format=sell|hybrid, --devices=N>1,\n")
    f.write("  --papi-event-*, --trace=DIR, --backend=xla\n\n")
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


def parse_args(argv: list[str], program: str) -> Options:
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
            print_help(program)
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
        elif (v := _split_eq(arg, "--papi-event-file")) is not False:
            need_value(v, "--papi-event-file")
            opts.papi_flags.append("--papi-event-file")
        elif (v := _split_eq(arg, "--papi-event-format")) is not False:
            if need_value(v, "--papi-event-format") not in ("plain", "csv"):
                raise CliError("--papi-event-format must be plain or csv")
            opts.papi_flags.append("--papi-event-format")
        elif arg in ("--papi-event-per-thread", "--papi-event-summary"):
            opts.papi_flags.append(arg)
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
        elif (v := _split_eq(arg, "--format")) is not False:
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
    """The first given option that this port does not have yet, or None."""
    if opts.format in ("sell", "hybrid"):
        return f"--format={opts.format}"
    if opts.devices > 1:
        return f"--devices={opts.devices}"
    if opts.papi_flags:
        return opts.papi_flags[0]
    if opts.trace_dir is not None:
        return "--trace"
    if opts.backend == "xla":
        return "--backend=xla"
    return None


def kernel_name(opts: Options, mat) -> str:
    """Kernel label in the reference's naming (gemv/gemvsd/gemv16,
    README:133), and gemv_dia or gemv_stream for DIA or the stream format,
    as in the JAX program."""
    from ellspmv_tpu_torch.formats.dia import DiaMatrix
    from ellspmv_tpu_torch.formats.stream import StreamMatrix
    if isinstance(mat, DiaMatrix):
        return "gemv_dia"
    if isinstance(mat, StreamMatrix):
        return "gemv_stream"
    if opts.separate_diagonal and mat.rowsize == 16:
        return "gemv16"
    return "gemvsd" if opts.separate_diagonal else "gemv"


def _convert(coo, opts: Options, index_dtype, device):
    """The matrix in the format `opts` asks for, on `device`, with the name
    and the tail of the verbose conversion line (ellspmv_tpu.cli.common
    ._convert)."""
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


def run(argv: list[str], program: str) -> int:
    """The program's main body."""
    try:
        opts = parse_args(argv, program)
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
    if opts.separate_diagonal and opts.format == "dia" and opts.verbose:
        log.write(f"{program}: note: --format=dia stores the diagonal "
                  "inline; --separate-diagonal ignored\n")
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
        mat, convert_name, per_row = _convert(coo, opts, index_dtype, device)
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
    # chained slope). --backend=auto and --backend=pallas both run the
    # hand-written kernel.
    try:
        res = benchmark_spmv(None, mat, x, y, repeat=opts.repeat,
                             warmup=opts.warmup, protocol=opts.protocol)
    except Exception as e:
        sys.stderr.write(f"{program}: benchmark failed: {e}\n")
        return 1
    if opts.verbose:
        name = kernel_name(opts, mat)
        for line in res.iteration_lines():
            log.write(f"{name}: {line}\n")
        if res.warning:
            log.write(f"{program}: warning: {res.warning}\n")

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
