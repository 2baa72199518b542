"""Multi-host (multi-process) distributed initialization test.

Runs TWO real Python processes with the CPU backend (2 virtual devices
each), initializes ``jax.distributed`` through ``parallel.distributed``,
builds the ICI-inner/DCN-outer mesh and executes a cross-process psum --
so the multi-host code path is EXECUTED, not just imported.
"""
import os
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from any4.parallel import distributed

    pid = int(sys.argv[1])
    ok = distributed.initialize(coordinator_address=sys.argv[2],
                                num_processes=2, process_id=pid)
    assert ok
    assert jax.process_count() == 2
    assert jax.local_device_count() == 2
    assert jax.device_count() == 4
    assert distributed.is_primary() == (pid == 0)

    mesh = distributed.make_multihost_mesh(tp=2)
    assert dict(mesh.shape) == {{"dp": 2, "tp": 2}}
    # tp must stay within one process (the "slice"): both devices of each
    # mesh row live on the same process
    for row in np.asarray(mesh.devices):
        assert len({{d.process_index for d in row}}) == 1

    # a cross-process collective: psum over the dp (DCN) axis
    sharding = NamedSharding(mesh, P("dp"))
    garr = jax.make_array_from_callback(
        (4,), sharding,
        lambda idx: np.arange(4.0, dtype=np.float32)[idx])
    f = jax.jit(jax.shard_map(
        lambda a: jax.lax.psum(a, "dp"), mesh=mesh,
        in_specs=P("dp"), out_specs=P(None)))
    out = f(garr)
    local = np.asarray(out.addressable_shards[0].data)
    np.testing.assert_allclose(local, np.array([2.0, 4.0], np.float32))
    print(f"worker {{pid}} OK", flush=True)
""")


@pytest.mark.skipif(os.environ.get("ANY4_SKIP_MULTIPROC") == "1",
                    reason="multi-process test disabled")
def test_two_process_distributed_psum(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=repo))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")}
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), coord],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-2000:]}"
        assert f"worker {i} OK" in out
