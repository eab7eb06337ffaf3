"""dy2static: AST transforms that turn tensor-dependent Python control
flow into ``torch.export``-traceable higher-order ops.

Port of ``paddle_tpu/jit/dy2static.py`` (the reference's
python/paddle/jit/dy2static: ast_transformer.py, convert_operators.py).
The transformer is the reference's, unchanged: ``if`` / ``while`` /
``for i in range(n)`` / ``and`` / ``or`` / ``not`` / ``a if c else b``
/ ``assert`` / ``print`` become calls of the runtime helpers below. Where
the reference hands a traced predicate to ``lax.cond`` /
``lax.while_loop`` / ``lax.fori_loop``, the port hands it to
``torch.cond`` and ``torch._higher_order_ops.while_loop``, which
``torch.export`` records (the port's counterpart of the reference's
``jax.jit``, and what ``jit.save`` uses). A predicate is traced while a
program is being exported; everywhere else the port runs eagerly, the
predicate is concrete, and the original Python control flow runs.

Contracts, as the reference's: a variable mutated in a branch or a loop
must be bound before it, both branches give tensors of one structure,
shape and dtype, a predicate is a scalar; a violation raises
``Dy2StaticError``. Under export, ``print`` prints while the program is
traced (an exported program has no print op) and ``assert`` checks
nothing (ROADMAP, Queue 3).
"""
import ast
import functools
import inspect
import textwrap
import types

import numpy as np
import torch

__all__ = ["convert_to_static", "Dy2StaticError", "convert_ifelse",
           "convert_while_loop", "convert_for_range", "convert_logical_and",
           "convert_logical_or", "convert_logical_not", "convert_bool",
           "convert_ifexp", "convert_assert", "convert_print", "UNDEFINED"]


class Dy2StaticError(RuntimeError):
    pass


class _Undefined:
    """Placeholder for a name first bound inside a control-flow branch
    (the reference's UndefinedVar, python/paddle/jit/dy2static/utils.py):
    seeded before the rewritten ``if`` so the name can be passed to the
    branches; using the value raises instead of UnboundLocalError."""

    def _err(self, *a, **k):
        raise Dy2StaticError(
            "variable was only assigned along one control-flow branch and "
            "is used before being defined on the taken path")

    __bool__ = __add__ = __radd__ = __sub__ = __rsub__ = _err
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _err
    __floordiv__ = __rfloordiv__ = __mod__ = __rmod__ = _err
    __pow__ = __rpow__ = __matmul__ = __rmatmul__ = _err
    __neg__ = __pos__ = __abs__ = __invert__ = _err
    __eq__ = __ne__ = __lt__ = __le__ = __gt__ = __ge__ = _err
    __call__ = __getitem__ = __setitem__ = __iter__ = __len__ = _err
    __int__ = __float__ = __index__ = __complex__ = _err
    __array__ = __contains__ = _err
    __hash__ = object.__hash__  # defining __eq__ would otherwise unset it

    def __getattr__(self, name):
        # dunder probes (copy/pickle/inspect protocols) must fall through
        # as plain AttributeError; any real attribute use is an error
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        self._err()

    def __repr__(self):
        return "<dy2static UNDEFINED>"


UNDEFINED = _Undefined()


def _seed_stmts(names):
    """`try: n\nexcept NameError: n = UNDEFINED` for each name, so names
    first bound inside the rewritten block exist before the runtime call."""
    return [ast.Try(
        body=[ast.Expr(value=_name(n))],
        handlers=[ast.ExceptHandler(
            type=_name("NameError"), name=None,
            body=[ast.Assign(targets=[_name(n, ast.Store)],
                             value=_jst_attr("UNDEFINED"))])],
        orelse=[], finalbody=[]) for n in names]


# ---------------------------------------------------------------- runtime

def _raw(x):
    from ..core.tensor import Tensor
    return x._value if isinstance(x, Tensor) else x


def _tracing():
    return torch.compiler.is_exporting() or torch.compiler.is_compiling()


def _is_traced(x):
    """Whether ``x`` is a tensor of a program being traced (exported)."""
    return torch.is_tensor(_raw(x)) and _tracing()


def _pred(x):
    """A predicate as a traced bool scalar tensor or a Python bool.
    Concrete values (numpy and 0-d tensors too) become a Python bool so
    the eager path is taken."""
    r = _raw(x)
    if torch.is_tensor(r) or isinstance(r, np.ndarray):
        numel = r.numel() if torch.is_tensor(r) else r.size
        if r.ndim != 0 and numel != 1:
            raise Dy2StaticError(
                "control-flow predicate must be a scalar (got shape "
                f"{tuple(r.shape)})")
    if _is_traced(r):
        return r.reshape(()).to(torch.bool)
    return bool(r)


def _strip(vals):
    """A loop body's values as a tuple of torch tensors."""
    out = []
    for v in vals:
        r = _raw(v)
        if not torch.is_tensor(r):
            raise Dy2StaticError(
                f"a traced branch or loop carries a {type(v).__name__}; "
                "only tensors can (bind the name to a tensor before the "
                "control flow)")
        out.append(r)
    return tuple(out)


def _flat(out):
    """(tensor leaves, tree spec) of a branch's output."""
    from torch.utils import _pytree
    leaves, spec = _pytree.tree_flatten(
        out, is_leaf=lambda v: not isinstance(v, (tuple, list, dict)))
    return _strip(leaves), spec


def _fresh(outs):
    """``outs`` cloned: a higher-order op's branch or body may not return
    (a view of) an operand, and it is traced by dynamo, which cannot ask
    a tensor whether it is one."""
    return tuple(o.clone() for o in outs)


def _split(args):
    """(positions of the tensor args, a function rebuilding the args from
    new tensor values)."""
    args = tuple(args)
    pos = [i for i, a in enumerate(args) if torch.is_tensor(_raw(a))]

    def rebuild(tvals):
        full = list(args)
        for i, v in zip(pos, tvals):
            full[i] = v
        return full

    return pos, rebuild


def _probe(fn, args):
    """(the leaves' dtypes and shapes, the tree spec) of ``fn(*args)`` on
    the traced values, recording nothing: at the top of an export with
    the tracer switched off, inside an enclosing branch (which dynamo
    traces) as dead code the export drops."""
    if torch.compiler.is_dynamo_compiling():
        leaves, spec = _flat(fn(*args))
    else:
        from torch.fx.experimental.proxy_tensor import \
            disable_proxy_modes_tracing
        with disable_proxy_modes_tracing():
            leaves, spec = _flat(fn(*args))
    return [(str(o.dtype), tuple(str(d) for d in o.shape))
            for o in leaves], spec


def convert_ifelse(pred, true_fn, false_fn, args):
    """The reference's convert_ifelse: Python's ``if`` on a concrete
    predicate, ``torch.cond`` on a traced one (its branches take the
    tensors among ``args`` as operands and close over the rest). Both
    branches must give tensors of one structure, dtype and shape
    (``lax.cond``'s contract, which the reference keeps; ``torch.cond``
    would let shapes differ): ``Dy2StaticError`` otherwise."""
    p = _pred(pred)
    if isinstance(p, bool):
        return true_fn(*args) if p else false_fn(*args)
    t_meta, spec = _probe(true_fn, args)
    f_meta, f_spec = _probe(false_fn, args)
    if t_meta != f_meta or spec != f_spec:
        raise Dy2StaticError(
            f"if/else branches returned mismatched structures under "
            f"tracing: {t_meta} vs {f_meta}")
    pos, rebuild = _split(args)

    def branch(fn):
        def run(*tvals):
            return _fresh(_flat(fn(*rebuild(tvals)))[0])
        return run

    try:
        out = torch.cond(p, branch(true_fn), branch(false_fn),
                         tuple(_raw(args[i]) for i in pos))
    except Dy2StaticError:
        raise
    except Exception as e:
        raise Dy2StaticError(
            f"if/else branches failed under tracing: {e}") from None
    from torch.utils import _pytree
    return _pytree.tree_unflatten(list(out), spec)


def _while(cond, body, carry):
    from torch._higher_order_ops.while_loop import while_loop
    try:
        return tuple(while_loop(cond, body, carry))
    except Dy2StaticError:
        raise
    except Exception as e:
        raise Dy2StaticError(
            f"a traced loop's body changed its carry's structure, shape "
            f"or dtype: {e}") from None


def convert_while_loop(cond_fn, body_fn, carry):
    """``while``: a Python loop on a concrete predicate, ``while_loop``
    over the tensors among the carry on a traced one."""
    p = _pred(cond_fn(*carry))
    if isinstance(p, bool):  # concrete: plain Python loop
        while _pred(cond_fn(*carry)):
            carry = body_fn(*carry)
        return carry
    pos, rebuild = _split(carry)
    if len(pos) != len(tuple(carry)):
        _strip(carry)       # raises: a traced loop carries tensors only

    def c(*state):
        return _pred(cond_fn(*state))

    def b(*state):
        return _fresh(_strip(body_fn(*state)))

    return _while(c, b, _strip(carry))


def convert_for_range(n, body_fn, carry):
    """``for i in range(n)``: a Python loop for a concrete ``n``, a
    ``while_loop`` over (i, carry) for a traced one."""
    if not _is_traced(n):
        for i in range(int(_raw(n))):
            carry = body_fn(i, *carry)
        return carry
    bound = _raw(n).reshape(())
    state = (torch.zeros((), dtype=bound.dtype, device=bound.device),) \
        + _strip(carry)

    def c(i, *rest):
        return i < bound

    def b(i, *rest):
        return (i + 1,) + _fresh(_strip(body_fn(i, *rest)))

    return _while(c, b, state)[1:]


def convert_logical_and(lhs_fn, rhs_fn):
    lv = lhs_fn()
    if not _is_traced(lv):
        return rhs_fn() if lv else lv
    return torch.logical_and(_raw(lv), _raw(rhs_fn()))


def convert_logical_or(lhs_fn, rhs_fn):
    lv = lhs_fn()
    if not _is_traced(lv):
        return lv if lv else rhs_fn()
    return torch.logical_or(_raw(lv), _raw(rhs_fn()))


def convert_logical_not(x):
    if not _is_traced(x):
        return not x
    return torch.logical_not(_raw(x))


def convert_bool(x):
    """`if x:` predicate evaluation hook."""
    return _pred(x)


def convert_ifexp(pred, true_fn, false_fn):
    """``a if cond else b``, through ``convert_ifelse`` so a traced
    predicate keeps tuple outputs whole."""
    return convert_ifelse(pred, lambda: true_fn(), lambda: false_fn(), ())


def convert_assert(pred, message=None):
    """``assert``: a real assert on a concrete predicate; a traced one
    checks nothing, as in the reference. ``message`` may be a zero-arg
    callable (the transformer wraps the message in a lambda, so it is
    evaluated only on failure, as Python does)."""
    p = _pred(pred)
    if isinstance(p, bool):
        if not p:
            if callable(message):
                message = message()
            raise AssertionError(message if message is not None else "")
    return None


def convert_print(*args, **kwargs):
    """``print``. A traced tensor prints as its shape and dtype, while the
    program is traced; an exported program has no print op."""
    if any(_is_traced(a) for a in args):
        args = [f"Tensor(shape={list(_raw(a).shape)}, "
                f"dtype={str(_raw(a).dtype).replace('torch.', '')})"
                if _is_traced(a) else a for a in args]
    return print(*args, **kwargs)


# --------------------------------------------------------------- analysis

class _AssignedNames(ast.NodeVisitor):
    """Names bound by assignment/augassign/for-target inside a block."""

    def __init__(self):
        self.names = []

    def _add(self, t):
        if isinstance(t, ast.Name):
            if t.id not in self.names:
                self.names.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._add(e)

    def visit_Assign(self, node):
        for t in node.targets:
            self._add(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._add(node.target)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        self._add(node.target)
        self.generic_visit(node)

    def visit_For(self, node):
        self._add(node.target)
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        pass  # nested defs bind their own scope


def _assigned(stmts):
    v = _AssignedNames()
    for s in stmts:
        v.visit(s)
    return v.names


def _load_names(node):
    return sorted({n.id for n in ast.walk(node)
                   if isinstance(n, ast.Name)
                   and isinstance(n.ctx, ast.Load)})


def _has_disallowed(stmts):
    """Return/break/continue/yield in THIS block's scope (nested function
    defs — including our own generated branch functions — have their own
    scope and must not count)."""
    def scan(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return None
        if isinstance(node, (ast.Return, ast.Break, ast.Continue,
                             ast.Yield, ast.YieldFrom)):
            return type(node).__name__
        for child in ast.iter_child_nodes(node):
            r = scan(child)
            if r:
                return r
        return None

    for s in stmts:
        r = scan(s)
        if r:
            return r
    return None


_JST = "_paddle_tpu_torch_jst"


def _name(n, ctx=ast.Load):
    return ast.Name(id=n, ctx=ctx())

def _jst_attr(fn):
    return ast.Attribute(value=_name(_JST), attr=fn, ctx=ast.Load())


# ------------------------------------------------------------ transformer

class _ControlFlowTransformer(ast.NodeTransformer):
    """The reference's IfElse/Loop/Logical transformers in one pass.

    ``shadowed``: names bound locally in the function being transformed
    (params + assignments) — builtin rewrites (print) skip these.
    """

    def __init__(self, shadowed=()):
        self._counter = 0
        self._shadowed = frozenset(shadowed)

    def _fresh(self, kind):
        self._counter += 1
        return f"__dy2st_{kind}_{self._counter}"

    # -- logical ops -----------------------------------------------------
    def visit_BoolOp(self, node):
        self.generic_visit(node)
        fn = ("convert_logical_and" if isinstance(node.op, ast.And)
              else "convert_logical_or")
        out = node.values[-1]
        for v in reversed(node.values[:-1]):
            out = ast.Call(
                func=_jst_attr(fn),
                args=[ast.Lambda(args=ast.arguments(
                          posonlyargs=[], args=[], kwonlyargs=[],
                          kw_defaults=[], defaults=[]), body=v),
                      ast.Lambda(args=ast.arguments(
                          posonlyargs=[], args=[], kwonlyargs=[],
                          kw_defaults=[], defaults=[]), body=out)],
                keywords=[])
        return ast.copy_location(out, node)

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.copy_location(ast.Call(
                func=_jst_attr("convert_logical_not"),
                args=[node.operand], keywords=[]), node)
        return node

    def visit_IfExp(self, node):
        self.generic_visit(node)
        mk = lambda b: ast.Lambda(
            args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                               kw_defaults=[], defaults=[]), body=b)
        return ast.copy_location(ast.Call(
            func=_jst_attr("convert_ifexp"),
            args=[node.test, mk(node.body), mk(node.orelse)],
            keywords=[]), node)

    def visit_Assert(self, node):
        self.generic_visit(node)
        args = [node.test]
        if node.msg is not None:
            # lambda-wrap: Python evaluates assert messages lazily (only
            # on failure) — an eager arg would run side effects/indexing
            # on the success path too
            args.append(ast.Lambda(
                args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                                   kw_defaults=[], defaults=[]),
                body=node.msg))
        return ast.copy_location(ast.Expr(value=ast.Call(
            func=_jst_attr("convert_assert"), args=args, keywords=[])),
            node)

    def visit_Call(self, node):
        self.generic_visit(node)
        if isinstance(node.func, ast.Name) and node.func.id == "print" \
                and "print" not in self._shadowed:
            return ast.copy_location(ast.Call(
                func=_jst_attr("convert_print"), args=node.args,
                keywords=node.keywords), node)
        return node

    # -- if/else ---------------------------------------------------------
    def visit_If(self, node):
        self.generic_visit(node)
        bad = _has_disallowed(node.body) or _has_disallowed(node.orelse)
        if bad:
            return node  # leave untransformed: works eagerly, and under
            # trace the predicate's bool() raises
        assigned = sorted(set(_assigned(node.body))
                          | set(_assigned(node.orelse)))
        if not assigned:
            return node
        tname, fname = self._fresh("true"), self._fresh("false")
        ret = ast.Return(value=ast.Tuple(
            elts=[_name(a) for a in assigned], ctx=ast.Load()))

        def mk(fn_name, body):
            return ast.FunctionDef(
                name=fn_name,
                args=ast.arguments(
                    posonlyargs=[],
                    args=[ast.arg(arg=a) for a in assigned],
                    kwonlyargs=[], kw_defaults=[], defaults=[]),
                body=(body or [ast.Pass()]) + [ret],
                decorator_list=[], type_params=[])

        call = ast.Assign(
            targets=[ast.Tuple(elts=[_name(a, ast.Store)
                                     for a in assigned], ctx=ast.Store())],
            value=ast.Call(
                func=_jst_attr("convert_ifelse"),
                args=[node.test, _name(tname), _name(fname),
                      ast.Tuple(elts=[_name(a) for a in assigned],
                                ctx=ast.Load())],
                keywords=[]))
        out = _seed_stmts(assigned) + [mk(tname, node.body),
                                       mk(fname, node.orelse), call]
        for stmt in out:
            ast.copy_location(stmt, node)
            ast.fix_missing_locations(stmt)
        return out

    # -- while -----------------------------------------------------------
    def visit_While(self, node):
        self.generic_visit(node)
        if node.orelse or _has_disallowed(node.body):
            return node
        # only names REBOUND in the body become loop carries; names that
        # are merely read resolve lexically from the enclosing scope
        carry = [c for c in _assigned(node.body)
                 if not c.startswith("__dy2st")]
        if not carry:
            return node
        cname, bname = self._fresh("cond"), self._fresh("body")
        args = ast.arguments(posonlyargs=[],
                             args=[ast.arg(arg=a) for a in carry],
                             kwonlyargs=[], kw_defaults=[], defaults=[])
        cond_fn = ast.FunctionDef(
            name=cname, args=args,
            body=[ast.Return(value=node.test)], decorator_list=[], type_params=[])
        body_fn = ast.FunctionDef(
            name=bname, args=args,
            body=node.body + [ast.Return(value=ast.Tuple(
                elts=[_name(a) for a in carry], ctx=ast.Load()))],
            decorator_list=[], type_params=[])
        call = ast.Assign(
            targets=[ast.Tuple(elts=[_name(a, ast.Store) for a in carry],
                               ctx=ast.Store())],
            value=ast.Call(
                func=_jst_attr("convert_while_loop"),
                args=[_name(cname), _name(bname),
                      ast.Tuple(elts=[_name(a) for a in carry],
                                ctx=ast.Load())],
                keywords=[]))
        out = _seed_stmts(carry) + [cond_fn, body_fn, call]
        for stmt in out:
            ast.copy_location(stmt, node)
            ast.fix_missing_locations(stmt)
        return out

    # -- for i in range(...) ---------------------------------------------
    def visit_For(self, node):
        self.generic_visit(node)
        is_range = (isinstance(node.iter, ast.Call)
                    and isinstance(node.iter.func, ast.Name)
                    and node.iter.func.id == "range"
                    and len(node.iter.args) == 1
                    and isinstance(node.target, ast.Name))
        if not is_range or node.orelse or _has_disallowed(node.body):
            return node
        assigned = [a for a in _assigned(node.body)
                    if a != node.target.id and not a.startswith("__dy2st")]
        if not assigned:
            return node
        bname = self._fresh("forbody")
        body_fn = ast.FunctionDef(
            name=bname,
            args=ast.arguments(
                posonlyargs=[],
                args=[ast.arg(arg=node.target.id)]
                + [ast.arg(arg=a) for a in assigned],
                kwonlyargs=[], kw_defaults=[], defaults=[]),
            body=node.body + [ast.Return(value=ast.Tuple(
                elts=[_name(a) for a in assigned], ctx=ast.Load()))],
            decorator_list=[], type_params=[])
        call = ast.Assign(
            targets=[ast.Tuple(elts=[_name(a, ast.Store)
                                     for a in assigned], ctx=ast.Store())],
            value=ast.Call(
                func=_jst_attr("convert_for_range"),
                args=[node.iter.args[0], _name(bname),
                      ast.Tuple(elts=[_name(a) for a in assigned],
                                ctx=ast.Load())],
                keywords=[]))
        out = _seed_stmts(assigned) + [body_fn, call]
        for stmt in out:
            ast.copy_location(stmt, node)
            ast.fix_missing_locations(stmt)
        return out


# --------------------------------------------------------------- frontend
#
# Two-level cache design:
#  - `_code_cache` memoizes the EXPENSIVE part (source → AST transform →
#    compiled code object) per func.__code__; None marks untransformable.
#  - The returned function is built per closure by binding the transformed
#    code to the ORIGINAL cell objects via types.FunctionType, so free
#    variables stay live (a later `nonlocal` rebind is seen, unlike a
#    bake-values-into-globals scheme) and factory closures never share
#    state. `_fn_memo` is a small bounded LRU keyed by (code, cell ids)
#    purely to return one function for repeated to_static calls
#    on the same closure; eviction only costs a re-bind, never correctness.

_code_cache = {}   # func.__code__ -> transformed inner code object | None
_fn_memo = {}      # (code, cell-id-tuple) -> (fn, cells)  [bounded]
_FN_MEMO_MAX = 512
_MISSING = object()


def _transform_to_code(func):
    """Parse+transform func's source; return a code object whose free
    variables match the original's (so original cells can be bound)."""
    src = textwrap.dedent(inspect.getsource(func))
    tree = ast.parse(src)
    fdef = tree.body[0]
    # drop decorators: the transformed fn is called by the wrapper
    if isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        fdef.decorator_list = []
    shadowed = set()
    if isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = fdef.args
        shadowed = {p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)}
        if a.vararg:
            shadowed.add(a.vararg.arg)
        if a.kwarg:
            shadowed.add(a.kwarg.arg)
        shadowed |= set(_assigned(fdef.body))
    tree = _ControlFlowTransformer(shadowed=shadowed).visit(tree)
    ast.fix_missing_locations(tree)
    freevars = func.__code__.co_freevars
    if freevars:
        # wrap in an outer def whose params are the free names: compiling
        # it makes those names free in the inner code object, which we
        # then extract and later bind to the ORIGINAL cells
        outer = ast.FunctionDef(
            name="__dy2st_outer__",
            args=ast.arguments(
                posonlyargs=[],
                args=[ast.arg(arg=n) for n in freevars],
                kwonlyargs=[], kw_defaults=[], defaults=[]),
            body=[fdef, ast.Return(value=_name(fdef.name))],
            decorator_list=[], type_params=[])
        tree = ast.Module(body=[outer], type_ignores=[])
        ast.fix_missing_locations(tree)
    mod_code = compile(tree, filename=f"<dy2static {func.__name__}>",
                       mode="exec")
    # dig out the function's code object (possibly nested in the outer)
    holder = mod_code
    if freevars:
        holder = next(c for c in mod_code.co_consts
                      if isinstance(c, types.CodeType)
                      and c.co_name == "__dy2st_outer__")
    inner = next(c for c in holder.co_consts
                 if isinstance(c, types.CodeType)
                 and c.co_name == func.__name__)
    return inner


def convert_to_static(func):
    """Rewrite `func`'s control flow for tracing; returns the transformed
    function (reference: program_translator.py StaticFunction +
    ast_transformer pipeline). Falls back to the original on any source/
    parse failure (builtins, lambdas, REPL)."""
    code = getattr(func, "__code__", None)
    if code is None:
        return func
    # jit.ignore_module registry: functions defined in an ignored module
    # run untransformed (reference dy2static ignore_module semantics)
    from . import _ignored_modules
    mod_name = getattr(func, "__module__", None)
    for m in _ignored_modules:
        ignored = getattr(m, "__name__", m)
        if mod_name == ignored:
            return func
    cells = getattr(func, "__closure__", None)
    memo_key = (code, tuple(id(c) for c in cells) if cells else None)
    hit = _fn_memo.get(memo_key)
    if hit is not None:
        return hit[0]

    entry = _code_cache.get(code, _MISSING)
    if entry is _MISSING:
        try:
            entry = _transform_to_code(func)
        except (OSError, TypeError, SyntaxError, IndexError, KeyError,
                ValueError, StopIteration):
            entry = None
        _code_cache[code] = entry
    if entry is None:
        return func

    import sys
    # the function's own globals, with the helpers' module under one
    # private name: dynamo, which traces a traced branch, reads a
    # function's globals from its module
    glb = func.__globals__
    glb[_JST] = sys.modules[__name__]
    try:
        if cells:
            cellmap = dict(zip(code.co_freevars, cells))
            closure = tuple(cellmap[n] for n in entry.co_freevars)
        else:
            closure = None
        new_fn = types.FunctionType(entry, glb, func.__name__,
                                    func.__defaults__, closure)
        new_fn.__kwdefaults__ = func.__kwdefaults__
        new_fn = functools.wraps(func)(new_fn)
    except (KeyError, TypeError):
        _code_cache[code] = None
        return func
    if len(_fn_memo) >= _FN_MEMO_MAX:  # bounded: drop ~oldest half
        for k in list(_fn_memo)[:_FN_MEMO_MAX // 2]:
            del _fn_memo[k]
    _fn_memo[memo_key] = (new_fn, cells)
    return new_fn
