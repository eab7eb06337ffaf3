"""The train step of the port.

Counterpart of ``paddle_tpu.jit.train_step_fn``. The JAX package traces
forward, backward and update into one jitted program over ``(params,
opt_state, batch, step)`` and returns the new parameters and state;
PyTorch runs eagerly and its autograd takes the place of the JAX
package's tape (``core/tape.py``), so here the step is a plain function
of the batch that updates the module's parameters, and the optimizer its
state, IN PLACE.

The step honours the optimizer's ``grad_clip`` and learning-rate
scheduler through ``optimizer.step()``: the clip's own ``clip_values``
inside the update, as the reference's ``Optimizer.step`` does. The
reference's ``train_step_fn`` instead always clips by the global norm,
reading ``grad_clip.clip_norm`` (``jit/__init__.py:166-170``); the two
agree for ``ClipGradByGlobalNorm`` (ROADMAP, Queue 3). The caller steps
the scheduler. Under ``amp.auto_cast`` the step's operators cast their
inputs as the reference's dispatch does.
"""

__all__ = ["train_step_fn"]


def train_step_fn(layer, loss_fn, optimizer):
    """``step(batch) -> loss``: ``loss_fn(layer(*batch["inputs"]),
    *batch.get("labels", ()))``, ``loss.backward()``,
    ``optimizer.step()``, ``optimizer.clear_grad()``. The parameters of
    ``layer`` and the optimizer's state are updated in place; the
    returned loss is detached from the graph."""

    def step(batch):
        out = layer(*batch["inputs"])
        loss = loss_fn(out, *batch.get("labels", ()))
        loss.backward()
        optimizer.step()
        optimizer.clear_grad()
        return loss.detach()

    return step
