"""horovod_tpu_torch.runner: the port's launcher (``launch.py``), its
rendezvous KV (``http_server.py``, ``http_client.py``, ``kvshard.py``),
host and slot assignment (``hosts.py``, ``lsf.py``, ``gpu_discovery.py``)
and ``run()`` (``api.py``, its workers placed by ``spark/runner.py``)."""
