"""The port's collective watchdog, heartbeat monitor and host-loss contract
(``photon_ml_tpu_torch.parallel.{multihost,heartbeat}``,
``photon_ml_tpu_torch.resilience.hostloss``), mirroring the cases of
``tests/test_multihost_resilience.py`` that touch no GAME checkpoint, and
holding the marker files byte for byte to the JAX package's."""

import threading
import time

import numpy as np
import pytest

from photon_ml_tpu.parallel import multihost as jmulti
from photon_ml_tpu.resilience import hostloss as jhostloss
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.parallel.heartbeat import (
    HeartbeatMonitor,
    InProcessHeartbeats,
    current_monitor,
    install_monitor,
)
from photon_ml_tpu_torch.resilience import (
    HOST_LOSS_EXIT_CODE,
    HostLossDetected,
    RetryBudgetExceeded,
    clear_host_loss_marker,
    is_host_loss,
    read_host_loss_marker,
    write_host_loss_marker,
)
from photon_ml_tpu_torch.resilience.faults import FaultSpec, inject


@pytest.fixture
def watchdog():
    prev = multihost.configure_collective_resilience(timeout_s=0.1, retries=2)
    try:
        yield multihost.collective_resilience()
    finally:
        multihost.configure_collective_resilience(prev.timeout_s, prev.retries)


class TestCollectiveWatchdog:
    def test_no_watchdog_is_passthrough(self):
        assert multihost.collective_resilience().timeout_s is None
        np.testing.assert_array_equal(multihost.allgather_host(np.arange(5)), np.arange(5))

    def test_stall_times_out_retries_and_recovers(self, watchdog):
        reg = obs.registry()
        before = reg.counter("collective.stalls").value
        t0 = time.perf_counter()
        with inject(FaultSpec("collective.stall", "delay", nth=1, delay=2.0)):
            out = multihost.allgather_host(np.arange(6))
        wall = time.perf_counter() - t0
        np.testing.assert_array_equal(out, np.arange(6))
        assert wall < 1.9, f"watchdog waited out the stall ({wall:.2f}s)"
        assert reg.counter("collective.stalls").value - before >= 1

    def test_peer_death_retries_through_backoff(self, watchdog):
        with inject(FaultSpec("collective.allreduce", "raise", nth=1)):
            out = multihost.allgather_host(np.arange(3))
        np.testing.assert_array_equal(out, np.arange(3))

    def test_exhausted_budget_is_host_loss(self, watchdog):
        with inject(FaultSpec("collective.stall", "delay", nth=1, count=-1, delay=0.4)):
            with pytest.raises(RetryBudgetExceeded) as ei:
                multihost.allgather_host(np.arange(2))
        assert isinstance(ei.value.__cause__, multihost.CollectiveTimeout)
        assert isinstance(ei.value.__cause__, OSError)
        assert is_host_loss(ei.value)

    def test_stall_event_carries_straggler_attribution(self, watchdog):
        mon = HeartbeatMonitor(interval_s=0.01, miss_intervals=1e6,
                               transport=InProcessHeartbeats(3),
                               process_index=0, process_count=3)
        mon.poll_once()
        prev = install_monitor(mon)
        try:
            with inject(FaultSpec("collective.stall", "delay", nth=1, delay=2.0)):
                multihost.allgather_host(np.arange(2))
            assert obs.registry().gauge("pod.heartbeat.slowest_host").value in (1, 2)
        finally:
            install_monitor(prev)

    def test_configure_validates(self):
        with pytest.raises(ValueError):
            multihost.configure_collective_resilience(timeout_s=-1.0)
        with pytest.raises(ValueError):
            multihost.configure_collective_resilience(retries=-1)

    def test_pod_live_orphan_escalates_instead_of_reissue(self, monkeypatch):
        monkeypatch.setattr(multihost, "process_count", lambda: 2)
        release = threading.Event()
        calls = []

        def wedged():
            calls.append(1)
            release.wait(30.0)

        prev = multihost.configure_collective_resilience(timeout_s=0.1, retries=2)
        try:
            with pytest.raises(multihost.CollectiveAbandoned) as ei:
                multihost._resilient_exchange("wedge_test", wedged)
        finally:
            release.set()
            multihost.configure_collective_resilience(prev.timeout_s, prev.retries)
        assert len(calls) == 1, "the wedged exchange was reissued"
        assert is_host_loss(ei.value)

    def test_pod_retry_consumes_late_orphan_result(self, monkeypatch):
        monkeypatch.setattr(multihost, "process_count", lambda: 2)
        calls = []

        def straggler():
            calls.append(1)
            time.sleep(0.35)
            return "late-but-aligned"

        prev = multihost.configure_collective_resilience(timeout_s=0.2, retries=2)
        try:
            out = multihost._resilient_exchange("straggler_test", straggler)
        finally:
            multihost.configure_collective_resilience(prev.timeout_s, prev.retries)
        assert out == "late-but-aligned"
        assert len(calls) == 1, "the completed exchange was reissued"

    def test_single_process_helpers_equal_jax(self):
        assert multihost.allgather_strings(["a", "bc"]) == jmulti.allgather_strings(["a", "bc"])
        np.testing.assert_array_equal(multihost.allgather_host(np.arange(4).reshape(2, 2)),
                                      jmulti.allgather_host(np.arange(4).reshape(2, 2)))
        assert multihost.initialize_multihost() is jmulti.initialize_multihost() is False
        assert multihost.fetch_replicated(3) == 3


class TestHeartbeatMonitor:
    def test_silent_peer_declared_lost_and_latched(self):
        mon = HeartbeatMonitor(interval_s=1e-3, miss_intervals=1.0,
                               transport=InProcessHeartbeats(2),
                               process_index=0, process_count=2)
        mon.poll_once()
        assert mon.lost_peers() == []
        time.sleep(0.01)
        with inject(FaultSpec("heartbeat.miss", "raise", nth=1, count=-1, key="1")):
            time.sleep(0.01)
            mon.poll_once()
        assert mon.lost_peers() == [1]
        with pytest.raises(HostLossDetected) as ei:
            mon.check()
        assert ei.value.peers == [1]
        mon.poll_once()
        assert mon.lost_peers() == [1]

    def test_background_thread_detects_without_boundary_polls(self):
        mon = HeartbeatMonitor(interval_s=5e-3, miss_intervals=2.0,
                               transport=InProcessHeartbeats(2),
                               process_index=0, process_count=2)
        with inject(FaultSpec("heartbeat.miss", "raise", nth=1, count=-1, key="1")):
            with mon:
                deadline = time.time() + 5.0
                while not mon.lost_peers() and time.time() < deadline:
                    time.sleep(5e-3)
        assert mon.lost_peers() == [1]

    def test_unpublished_peer_not_instantly_lost(self):
        class _SilentKV:
            def publish(self, pid, t):
                pass

            def read(self, self_pid):
                return {}

        mon = HeartbeatMonitor(interval_s=0.05, miss_intervals=2.0, transport=_SilentKV(),
                               process_index=0, process_count=2)
        ages = mon.poll_once()
        assert np.isfinite(ages[1]) and ages[1] < 1.0
        assert mon.lost_peers() == []
        time.sleep(0.12)
        mon.poll_once()
        assert mon.lost_peers() == [1]

    def test_gauges_and_slowest(self):
        mon = HeartbeatMonitor(interval_s=0.01, miss_intervals=1e6,
                               transport=InProcessHeartbeats(3),
                               process_index=0, process_count=3)
        mon.poll_once()
        assert obs.registry().gauge("pod.heartbeat.age_s.h1") is not None
        slow = mon.slowest()
        assert slow is not None and slow[0] in (1, 2)

    def test_knob_validation(self):
        with pytest.raises(ValueError):
            HeartbeatMonitor(interval_s=0.0)
        with pytest.raises(ValueError):
            HeartbeatMonitor(interval_s=1.0, miss_intervals=0.0)

    def test_install_current_roundtrip(self):
        mon = HeartbeatMonitor(interval_s=1.0, transport=InProcessHeartbeats(1),
                               process_index=0, process_count=1)
        prev = install_monitor(mon)
        try:
            assert current_monitor() is mon
        finally:
            install_monitor(prev)


class TestHostLoss:
    def test_exit_code_is_distinct(self):
        assert HOST_LOSS_EXIT_CODE == jhostloss.HOST_LOSS_EXIT_CODE
        assert HOST_LOSS_EXIT_CODE not in (0, 1, 2, 3)
        assert is_host_loss(HostLossDetected([1]))
        assert not is_host_loss(ValueError("boom"))
        assert str(HostLossDetected([2, 1], "watchdog")) == str(
            jhostloss.HostLossDetected([2, 1], "watchdog"))

    def test_host_loss_matches_by_type_not_name(self):
        class CollectiveTimeout(OSError):
            pass

        assert not is_host_loss(CollectiveTimeout("impostor"))
        assert is_host_loss(multihost.CollectiveTimeout("x", 1.0, 1))
        assert is_host_loss(multihost.CollectiveAbandoned("x", 1.0))
        wrapped = RetryBudgetExceeded("x", 3, 1.0)
        wrapped.__cause__ = multihost.CollectiveAbandoned("x", 2.0)
        assert is_host_loss(wrapped)
        # the JAX package's classes are not the port's
        assert not is_host_loss(jmulti.CollectiveTimeout("x", 1.0, 1))

    def test_torch_distributed_failures_are_host_loss(self):
        import torch.distributed as dist

        for name in ("DistBackendError", "DistNetworkError", "DistStoreError"):
            err = getattr(dist, name, None)
            if err is not None:
                assert is_host_loss(err("peer gone")), name
                wrapped = RuntimeError("solve failed")
                wrapped.__cause__ = err("timeout")
                assert is_host_loss(wrapped), name
        assert not is_host_loss(RuntimeError("not a collective"))

    @pytest.mark.parametrize("final", [True, False])
    def test_marker_bytes_equal_jax(self, tmp_path, final):
        a, b = tmp_path / "port", tmp_path / "jax"
        write_host_loss_marker(str(a), 7, [3, 1], reason="watchdog", final_checkpoint=final)
        jhostloss.write_host_loss_marker(str(b), 7, [3, 1], reason="watchdog",
                                         final_checkpoint=final)
        assert (a / "host-loss.json").read_bytes() == (b / "host-loss.json").read_bytes()
        assert read_host_loss_marker(str(a)) == jhostloss.read_host_loss_marker(str(b))
        clear_host_loss_marker(str(a))
        assert read_host_loss_marker(str(a)) is None
        clear_host_loss_marker(str(a))
