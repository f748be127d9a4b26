"""The ``bernoulli_rbm`` family: the port's ``BernoulliRBM`` trained by
CD-k through ``fit``, as ``examples/torch_rbm_mnist.py`` builds it."""

import os

import numpy as np

from ..harness.data import gaussian
from ..work import cd_step_work
from .training import FitSession

#: the port's launch counter of each kernel, and the kernel's name in a
#: trace (csrc/cd_epoch.cu)
KERNEL_OF_COUNTER = {'cd_gemm_act': 'cd_gemm_act_kernel',
                     'cd_softmax_sample': 'cd_softmax_sample_kernel',
                     'cd_bias_stats': 'cd_bias_stats_kernel',
                     'cd_assoc_update': 'assoc_kernel',
                     'cd_metrics': ('cd_metrics_fe_kernel',
                                    'cd_metrics_draw_kernel',
                                    'cd_metrics_kernel')}


class Session(FitSession):
    STATE = {'W': 'weights/W', 'vb': 'weights/vb', 'hb': 'weights/hb',
             'dW': 'grads_accumulators/dW', 'dvb': 'grads_accumulators/dvb',
             'dhb': 'grads_accumulators/dhb',
             'q': 'hidden_activations_means/q_means'}

    def build(self, weight_seed):
        from boltzmann_machines_tpu_torch import BernoulliRBM, logit_mean
        c = self.config
        V, H = c['n_visible'], c['n_hidden']
        self.W0 = gaussian((V, H), c['W_init'], weight_seed,
                           self.device).cpu().numpy()
        mc = c['metrics_config']
        self.period = int(np.lcm(mc['val_metrics_every_epoch'],
                                 mc['feg_every_epoch'] if mc['feg'] else 1))
        self.metrics_every = mc['train_metrics_every_iter']
        self.model = BernoulliRBM(
            n_visible=V, n_hidden=H, W_init=self.W0,
            vb_init=logit_mean(self.X) if c['vb_init'] == 'logit_mean'
            else c['vb_init'],
            hb_init=c['hb_init'], n_gibbs_steps=c['n_gibbs_steps'],
            learning_rate=self.schedule('learning_rate'),
            momentum=self.schedule('momentum'), max_epoch=0,
            batch_size=self.B, l2=c['l2'],
            sample_v_states=c['sample_v_states'],
            sample_h_states=c['sample_h_states'], dropout=None,
            sparsity_target=c['sparsity_target'],
            sparsity_cost=c['sparsity_cost'],
            sparsity_damping=c['sparsity_damping'],
            metrics_config=dict(mc), verbose=False,
            save_after_each_epoch=False, display_filters=0,
            display_hidden_activations=0, random_seed=self.model_seed,
            dtype='float32', device=self.device,
            model_path=os.path.join(self.workdir, 'rbm') + '/')
        # the state from W0 now; the checkpoint keeps the published scale
        # and not W0's 800 000 numbers, which params.json would hold
        self.model.get_params_arrays()
        self.model.set_params(W_init=c['W_init'])

    def counters(self):
        from boltzmann_machines_tpu_torch.ops.cd_epoch import cd_epoch
        return dict(cd_epoch.launches)

    def work_of_step(self, rows, window):
        c = self.config
        return cd_step_work(c['n_visible'], c['n_hidden'], rows,
                            c['n_gibbs_steps'], c['sample_h_states'],
                            c['sample_v_states'])

    def inputs(self):
        """What the reference needs: the inputs the benchmark made."""
        return {'config': self.config, 'batch_size': self.B, 'X': self.X,
                'rows': self.X[:3 * self.B], 'W0': self.W0,
                'random_seed': self.model_seed,
                'learning_rate': self.schedule('learning_rate'),
                'momentum': self.schedule('momentum')}
