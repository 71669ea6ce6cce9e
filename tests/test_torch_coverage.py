"""The port covers the JAX package: every public top-level ``def``,
``class`` and module-level name of each module of ``dispu_tpu/`` (read
from its source, not imported) exists in the port's counterpart module,
the module of the same path under ``dispu_tpu_torch/``.  The only
exceptions are those of ``EXCEPTIONS``, each with its reason.

Names a module only imports (a package ``__init__``'s re-exports) are not
counted; names that start with an underscore are private.

The options too: every parameter of a public function, and every field
(a flax Module's or a dataclass's annotated attribute) and call parameter
of a public class, is a parameter of the port's counterpart (of its
``__init__``, ``forward`` or ``__call__``) or a data attribute of its
class.  The JAX package's framework arguments (``FRAMEWORK_PARAMETERS``)
and the options of ``PARAMETER_EXCEPTIONS`` are excepted, each with its
reason.
"""

import ast
import importlib
import inspect
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PACKAGE = REPO / "dispu_tpu"

#: module path (relative to the package) → {name: reason}; a name of
#: ``"*"`` excepts the whole module
EXCEPTIONS = {
    "ops/pallas_kernels.py": {
        "*": "the TPU kernels: each function that reaches pl.pallas_call has "
             "a hand-written CUDA counterpart under dispu_tpu_torch/kernels/, "
             "listed by file and line in PERF.md's table of kernels",
    },
    "parallel/mesh.py": {
        "batch_sharding": "a jax.sharding.NamedSharding; torch.distributed "
                          "has no sharding object (the port's mesh shards "
                          "the batch by rank)",
        "replicated_sharding": "a jax.sharding.NamedSharding; the port's "
                               "parameters are replicated per process",
    },
    "train/state.py": {
        "adam_transform": "an optax GradientTransformation; the port's "
                          "Adam moments live in its GeneratorState",
    },
    "train/trainer.py": {
        "jnp_asarray": "converts host arrays to JAX arrays; the port's "
                       "trainer holds torch tensors",
    },
}

#: parameters that no port counterpart takes, wherever they appear
FRAMEWORK_PARAMETERS = {
    "dtype": "flax's compute dtype; a port module computes in its input's "
             "dtype (bf16 through the configs' compute_dtype)",
    "train": "flax's call-time mode; a port module follows "
             "Module.train() / Module.eval()",
    "key": "a JAX PRNG key; the port draws from a torch.Generator",
    "rng": "a JAX PRNG key; the port draws from a torch.Generator or "
           "takes a seed",
}

#: (module path, public name) → {parameter or field: reason}
PARAMETER_EXCEPTIONS = {
    ("native.py", "build"): {
        "force": "the port names the library by a hash of its source and "
                 "flags, so a stale build is never loaded",
    },
    ("nn/attention.py", "PointNonLocalCell"): {
        "attn_impl": "the port's one impl picks every kernel the module "
                     "reaches, attention.cu among them",
    },
    ("parallel/mesh.py", "make_mesh"): {
        "devices": "a torch.distributed process cannot pick its group's "
                   "devices; the port's mesh spans the default group",
    },
    ("parallel/mesh.py", "shard_batch"): {
        "data_axis": "the port's mesh has one data axis; the rows follow "
                     "the process's rank",
    },
    ("parallel/sharded_eval.py", "sharded_cd_hd"): {
        "data_axis": "the port's mesh has one data axis; the shards follow "
                     "the process's rank",
    },
    ("train/gan_steps.py", "GANState"): {
        "d_params": "the port's state holds the critic module (disc)",
        "d_opt_state": "the port's state holds the critic's Adam moments "
                       "(d_mu, d_nu, d_count)",
    },
    ("train/gan_steps.py", "make_gan_train_step"): {
        "donate": "XLA's buffer donation; the port's step runs eagerly",
        "jit_compile": "XLA's jit; the port's step runs eagerly",
    },
    ("train/state.py", "GeneratorState"): {
        "params": "the port's state holds the module (model)",
        "batch_stats": "the batch-norm statistics are the module's buffers",
        "opt_state": "the port's state holds the Adam moments (mu, nu, "
                     "count)",
    },
    ("train/state.py", "create_generator_state"): {
        "train_cfg": "the port's Adam reads TrainConfig in the step, so the "
                     "state's moments need none of it",
        "model": "the port builds the generator from gen_cfg; a built "
                 "module goes into a GeneratorState directly",
    },
    ("train/steps.py", "make_train_step"): {
        "donate": "XLA's buffer donation; the port's step runs eagerly",
        "jit_compile": "XLA's jit; the port's step runs eagerly",
    },
    ("utils/convert_tf_checkpoint.py", "expected_tf_names"): {
        "variables": "the port takes its generator's state_dict in place of "
                     "a flax variables tree",
    },
}


def public_names(path: pathlib.Path):
    """Public top-level def, class and assigned names of a source file."""
    names = []
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif (isinstance(node, ast.AnnAssign)
              and isinstance(node.target, ast.Name)):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_")]


def port_module(rel: pathlib.PurePath) -> str:
    parts = ("dispu_tpu_torch",) + rel.with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def missing_from_port(package=JAX_PACKAGE):
    """{module path: [names the port lacks]} over every module of the JAX
    package, the exceptions left out; a module the port lacks altogether
    maps to ``["<module>"]``."""
    gaps = {}
    for path in sorted(package.rglob("*.py")):
        rel = path.relative_to(package)
        key = rel.as_posix()
        excepted = EXCEPTIONS.get(key, {})
        if "*" in excepted:
            continue
        try:
            mod = importlib.import_module(port_module(rel))
        except ModuleNotFoundError:
            gaps[key] = ["<module>"]
            continue
        lacking = [n for n in public_names(path)
                   if n not in excepted and not hasattr(mod, n)]
        if lacking:
            gaps[key] = lacking
    return gaps


def public_options(path: pathlib.Path):
    """{public top-level def or class: its options}: a function's named
    parameters; a class's annotated fields and its ``__call__``'s named
    parameters but ``self``."""
    def params(fn):  # *args and **kwargs name no option
        a = fn.args
        return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]

    out = {}
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if node.__class__ not in (ast.FunctionDef, ast.ClassDef) or (
                node.name.startswith("_")):
            continue
        if isinstance(node, ast.FunctionDef):
            out[node.name] = params(node)
            continue
        opts = [s.target.id for s in node.body if isinstance(s, ast.AnnAssign)
                and isinstance(s.target, ast.Name)]
        for sub in node.body:
            if isinstance(sub, ast.FunctionDef) and sub.name == "__call__":
                opts += params(sub)[1:]
        out[node.name] = opts
    return out


def port_options(obj):
    """What the port's function or class takes: its parameters; a class's
    ``__init__``, ``forward`` and ``__call__`` parameters, dataclass
    fields and data attributes (no methods: ``nn.Module.train`` is not
    an option)."""
    fns = [obj]
    if inspect.isclass(obj):
        fns = [getattr(obj, m) for m in ("__init__", "forward", "__call__")
               if m in dir(obj)]
    names = set()
    for fn in fns:
        try:
            names |= set(inspect.signature(fn).parameters)
        except (TypeError, ValueError):  # a builtin's slot
            pass
    if inspect.isclass(obj):
        names |= set(getattr(obj, "__dataclass_fields__", ()))
        names |= {n for n in dir(obj)
                  if not callable(inspect.getattr_static(obj, n))}
    return names


def missing_options(package=JAX_PACKAGE):
    """{module path: {name: [options the port's counterpart lacks]}} over
    the names the port has, the exceptions left out."""
    gaps = {}
    for path in sorted(package.rglob("*.py")):
        rel = path.relative_to(package)
        key = rel.as_posix()
        if "*" in EXCEPTIONS.get(key, {}):
            continue
        try:
            mod = importlib.import_module(port_module(rel))
        except ModuleNotFoundError:
            continue
        for name, opts in public_options(path).items():
            if not hasattr(mod, name):
                continue
            have = port_options(getattr(mod, name))
            excepted = PARAMETER_EXCEPTIONS.get((key, name), {})
            lacking = [o for o in opts if o != "self" and o not in have
                       and o not in FRAMEWORK_PARAMETERS
                       and o not in excepted]
            if lacking:
                gaps.setdefault(key, {})[name] = lacking
    return gaps


def test_port_has_every_public_name():
    assert missing_from_port() == {}


def test_port_has_every_option():
    assert missing_options() == {}


def test_exceptions_are_real():
    """Every excepted name exists in its JAX module and is absent from
    the port, and the excepted module has no port counterpart."""
    for key, names in EXCEPTIONS.items():
        path = JAX_PACKAGE / key
        assert path.is_file(), key
        rel = pathlib.PurePath(key)
        if "*" in names:
            with pytest.raises(ModuleNotFoundError):
                importlib.import_module(port_module(rel))
            continue
        mod = importlib.import_module(port_module(rel))
        for name in names:
            assert name in public_names(path), (key, name)
            assert not hasattr(mod, name), (key, name)


def test_parameter_exceptions_are_real():
    """Every excepted option is an option of its JAX name, and the port's
    counterpart lacks it."""
    for (key, name), opts in PARAMETER_EXCEPTIONS.items():
        theirs = public_options(JAX_PACKAGE / key)[name]
        mod = importlib.import_module(port_module(pathlib.PurePath(key)))
        ours = port_options(getattr(mod, name))
        for opt in opts:
            assert opt in theirs, (key, name, opt)
            assert opt not in ours, (key, name, opt)


def test_every_tpu_kernel_has_a_row_in_the_table():
    """The kernels' exception: each function of ``ops/pallas_kernels.py``
    that calls ``pl.pallas_call`` has a row of PERF.md's table of kernels,
    which gives its name in backquotes and then its line, as in
    "`knn_pallas` (:867; :938)"."""
    path = JAX_PACKAGE / "ops" / "pallas_kernels.py"
    tree = ast.parse(path.read_text())
    calls = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and any(
                isinstance(sub, ast.Attribute) and sub.attr == "pallas_call"
                for sub in ast.walk(node)):
            calls.append((node.name, node.lineno))
    assert len(calls) == 13
    rows = [row for row in (REPO / "PERF.md").read_text().splitlines()
            if row.startswith("| ")]
    for name, line in calls:
        assert any(re.search(rf"`{name}` \(:{line};", row) for row in rows), (
            name, line)


def test_finds_a_gap(tmp_path):
    """The scan reports a name the port lacks and a module it lacks."""
    (tmp_path / "losses.py").write_text(
        "def chamfer():\n    pass\n\ndef no_such_loss():\n    pass\n"
        "ALIAS = chamfer\n_private = 1\n")
    (tmp_path / "nowhere.py").write_text("def f():\n    pass\n")
    assert missing_from_port(tmp_path) == {
        "losses.py": ["no_such_loss", "ALIAS"], "nowhere.py": ["<module>"]}


def test_finds_a_missing_option(tmp_path):
    """The scan reports a field, a call parameter and a function parameter
    the port lacks, and passes the framework's and those it has."""
    (tmp_path / "nn").mkdir()
    (tmp_path / "nn" / "edgeconv.py").write_text(
        "class DenseEdgeBlock:\n    growth_rate: int\n    no_such_field: int"
        "\n    dtype: object = None\n\n    def __call__(self, feature, "
        "no_such_arg=0, train=False):\n        pass\n\n"
        "def edge_feature(feature, k, no_such_option=1, key=None):\n"
        "    pass\n")
    assert missing_options(tmp_path) == {"nn/edgeconv.py": {
        "DenseEdgeBlock": ["no_such_field", "no_such_arg"],
        "edge_feature": ["no_such_option"]}}
